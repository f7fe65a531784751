"""How far a tiny change of the input moves an LM's logits, in the
reference (JAX) and the port on the same weights, in f32 on the CPU.

A model at its published widths, cut in depth (``--layers``), on the same
weights in both packages (``--weights``: ``init``, the reference's
``LM.init`` at seed 0, or ``seeded``, ``chip_smoke.py``'s
``seeded_weights``, phase 10's), prefills one prompt of TOKENS random
tokens twice: once as is, once with every entry of ``embed`` scaled by
(1 + REL x a standard normal draw; a tied head moves with it, by the
same ~REL).  It prints, for each package, the realised change of the
prompt's embedded rows and the change of the last position's logits,
each as max |difference| / max |value|, and their ratio (the
amplification).  ``chip_smoke.py`` phase 10 (e) holds zamba2 in f32
because of this number.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_mamba_sensitivity.py \\
        --arch zamba2-1.2b --layers 12 --weights seeded

Memory: about three copies of the cut model's f32 weights (zamba2-1.2b at
12 layers: 505M parameters, ~6 GiB).  The module holds no tests.
"""

import argparse
import dataclasses
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_config
from repro.configs.base import PoolGeometry as JGeo
from repro.models.lm import LM as JLM
from repro.serving.kv_cache import ShardedKVCache as JCache
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as t_config
from repro_torch.configs.base import PoolGeometry as TGeo
from repro_torch.models.lm import LM as TLM
from repro_torch.serving.kv_cache import ShardedKVCache as TCache

GEO_KW = dict(page_tokens=8, frame_pages=4)
N_PAGES = 32
ROOT = pathlib.Path(__file__).resolve().parents[1]
TOKENS = 64
REL = 1e-7      # about one f32 ulp (2^-23 = 1.2e-7) of each entry


def _scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _pages(tokens):
    return -(-tokens // GEO_KW["page_tokens"])


def seeded_tree(tcfg, like):
    """``chip_smoke.seeded_weights`` of ``tcfg`` on the CPU as a tree of
    ``like``'s structure (the reference's names, which the port's
    state_dict flattens with dots)."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    flat = {k: v.numpy() for k, v in
            chip_smoke.seeded_weights(tcfg, "cpu").items()}

    def fill(tree, prefix):
        return {k: fill(v, f"{prefix}{k}.") if isinstance(v, dict)
                else flat[f"{prefix}{k}"] for k, v in tree.items()}
    return fill(like, "")


def jax_logits(jlm, params, toks):
    """The reference's prefill logits at the prompt's last position."""
    pools = tuple(jnp.zeros(s.shape, jnp.float32) for s in jlm.pool_shapes(
        N_PAGES, GEO_KW["page_tokens"]) or ()) or None
    cache = JCache(JGeo(**GEO_KW), N_PAGES, 1)
    cache.allocate(0, toks.shape[1])
    logits, _, _ = jlm.prefill(params, {"tokens": jnp.asarray(toks)}, pools,
                               cache.pack_ctx([0], _pages(toks.shape[1])),
                               last_pos=jnp.asarray([toks.shape[1] - 1]))
    return np.asarray(logits, np.float32)


def torch_logits(tlm, toks):
    """The port's prefill logits at the prompt's last position."""
    pools = tuple(torch.zeros(s) for s, _ in tlm.pool_shapes(
        N_PAGES, GEO_KW["page_tokens"]) or ()) or None
    cache = TCache(TGeo(**GEO_KW), N_PAGES, 1)
    cache.allocate(0, toks.shape[1])
    with torch.no_grad():
        logits, _, _ = tlm.prefill(
            {"tokens": torch.from_numpy(toks)}, pools,
            cache.pack_ctx([0], _pages(toks.shape[1])),
            last_pos=torch.tensor([toks.shape[1] - 1]))
    return logits.float().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--weights", choices=("init", "seeded"), default="init")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    jcfg = dataclasses.replace(j_config(args.arch), n_layers=args.layers,
                               dtype="float32")
    tcfg = dataclasses.replace(t_config(args.arch), n_layers=args.layers,
                               dtype="float32")
    jlm = JLM(jcfg)
    params = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0)))
    if args.weights == "seeded":
        params = seeded_tree(tcfg, params)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (1, TOKENS)).astype(np.int32)
    embed = params["embed"]
    moved = (embed * (1 + REL * rng.standard_normal(embed.shape))
             ).astype(np.float32)
    rows_in = _scaled(moved[toks[0]], embed[toks[0]])
    out = dict(arch=args.arch, layers=args.layers, of_layers=j_config(
        args.arch).n_layers, tokens=TOKENS, rel=REL, weights=args.weights,
        embed_rows_change=rows_in)
    tlm = TLM(tcfg)
    for name, p in (("base", params), ("moved", dict(params, embed=moved))):
        out[f"jax_{name}"] = jax_logits(
            jlm, jax.tree.map(jnp.asarray, p), toks)
        tlm.load_state_dict(params_from_jax(p), strict=True)
        out[f"torch_{name}"] = torch_logits(tlm, toks)
    for pkg in ("jax", "torch"):
        gap = _scaled(out.pop(f"{pkg}_moved"), out[f"{pkg}_base"])
        out[f"{pkg}_logits_change"] = gap
        out[f"{pkg}_amplification"] = gap / rows_in
    out["port_vs_reference"] = _scaled(out.pop("torch_base"),
                                       out.pop("jax_base"))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
