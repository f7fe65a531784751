"""The system under test, ``repro_torch``, as the benchmark builds it.

``model_config`` turns a configuration file into the port's
``ModelConfig`` and, unless told otherwise (the CPU tests' smoke sizes),
refuses a file that differs from the port's own registry entry, so the
file states the configuration as it is run.  ``build_lm`` allocates the
port's ``LM`` and fills its weights in place from the seed
(:mod:`portbench.lib.weights`), after checking that its parameters are
exactly the ones the reference reads.
"""

from __future__ import annotations

import dataclasses

from portbench.lib import weights


def model_config(conf: dict, ref, strict: bool = True):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MLAConfig, MoEConfig
    base = get_config(conf["port_arch"])
    fields = dict(ref.port_fields(conf))
    if "moe" in fields:
        fields["moe"] = MoEConfig(**fields["moe"])
    if "mla" in fields:
        fields["mla"] = MLAConfig(**fields["mla"])
    cfg = dataclasses.replace(base, **fields)
    if strict and cfg != base:
        diff = {f.name: (getattr(base, f.name), getattr(cfg, f.name))
                for f in dataclasses.fields(base)
                if getattr(base, f.name) != getattr(cfg, f.name)}
        raise SystemExit(f"{conf['port_arch']}: the configuration file "
                         f"differs from the port's registry: {diff}")
    return cfg


def build_lm(cfg, conf: dict, ref, seed: int, device):
    from repro_torch.models.lm import LM
    lm = LM(cfg, device=device)
    have = {n: tuple(p.shape) for n, p in lm.named_parameters()}
    want = {n: tuple(s) for n, s in ref.param_shapes(conf).items()}
    if have != want:
        raise SystemExit(f"the port's LM parameters differ from the "
                         f"reference's: only in LM {sorted(set(have) - set(want))}"
                         f", only in reference {sorted(set(want) - set(have))}"
                         f", shapes {[(n, have[n], want[n]) for n in have if n in want and have[n] != want[n]]}")
    weights.fill(((n, p.data) for n, p in lm.named_parameters()), ref.init,
                 seed)
    return lm
