"""Multi-tenant continuous-batching serving engine on the Mosaic pool.

Counterpart of the reference's ``serving/engine.py`` for one engine:
admission with priority preemption, en-masse prefill, batched paged
decode, host-tier demand paging in three fault modes, and CAC compaction.

Lifecycle per request: admit → prefill (en-masse allocation) → join the
decode batch → complete → deallocate.  The pool may be oversubscribed: each
step ``touch()``es the pages its packed tables will read and faults the
missing ones in from the :class:`HostPageStore` (blocking: the whole
transfer is exposed); an allocation that hits ``OutOfMemory`` even after
CAC compaction preempts the cheapest-to-evict active request, whose
resident pages are gathered to the host store at base-page granularity and
faulted back in after it resumes.  A resumed request produces exactly the
tokens it would have produced unpreempted.

Fault modes (the reference's, same names, same default):

* ``"sync"``: the blocking path above.
* ``"async"`` (the default): each step first drains the prefetches that
  completed during the previous decode into the double-buffered staging
  region (:mod:`repro_torch.serving.dma`), faults only the remaining
  misses (exposed µs), then issues the predicted next-step touches so their
  transfers overlap this step's decode (hidden µs).  Eviction gathers ride
  the link's outbound lanes.  Only the modeled timeline differs from sync:
  every payload still lands through one host→device copy and one scatter.
* ``"fused"``: no pre-decode barrier.  This step's misses resolve to
  staged, in-flight or fresh demand payloads; they are copied to the card
  once as a step-local stage ``[L, NS, ptok, n_kv, dh]`` and decode reads
  them where they landed through the fused gather-attend kernel (a slot
  table beside the page tables), then the same bytes are scattered into
  the pool after decode.  The write page lands before decode.  Tokens are
  identical across the three modes because attention folds pages in the
  same order whatever their source.

Prefix-cache reuse (``prefix_cache=True``, the default, as in the
reference): finished prompts park their full pages' KV in the
:class:`PrefixIndex`, keyed by chained per-page content hash; the parking
gather rides the channels' "out" lanes.  An admission whose prompt shares a
cached page-aligned prefix prefills only the suffix, its queries attending
over the cached KV (uploaded for the attention), while the matched pages
are demoted and fault in through the modeled DMA pipeline like any other
host-backed page (prefetched at admission in async and fused mode).
Tokens are identical with the cache on or off where ``cfg.dtype`` is the
pools' bf16: the flash-attention kernel and prefill's fixed-shape row
blocks give a suffix row the full prefill's bits.

On a CUDA device every page movement, every prefill attention and every
decode attention runs in the port's hand-written kernels
(``repro_torch.kernels``); the gathers' copies to the host and the
fault-in scatters' copies to the card are the real PCIe transfers, moved a
frame at a time through page-locked slots
(:mod:`repro_torch.serving.page_ring`; counted in ``xfer_chunks``) and
timed into :class:`EngineStats`.  The modeled counters (``faults``,
``fault_dmas``, ``bytes_in``, ``transfer_us``, the prefix counters) come
from the same link model and bookkeeping as the reference's, so both
engines report them equal for the same schedule.

Families: all six of the LM's.  The recurrent families keep each request's
decode state (``self.states``: ``{"ssm", "conv"}``), and encdec its cross
K/V (``{"cross_k", "cross_v"}``, ~0.40 GB a request at seamless-m4t's
width), on the device, stacked along the batch axis for a decode step and
split after it; it stays put across preemption, where only KV pages swap.
A vlm request holds its ``frontend_tokens`` image positions in front of
the prompt in the pool.  The frontends are stubs, as in the reference:
prefill feeds zero patch embeddings (vlm) and zero source frames
(encdec).  The ssm family has no pools: its pages are bookkeeping only
(``page_bytes`` 0, no gather, scatter or compaction).  Only the dense
family uses the prefix cache, as in the reference: the cached pages hold
no recurrent state, image prefix or cross K/V, and MoE capacity depends on
the forward's length.  With MLA the pages hold K and V latent payloads of
different widths, and ``"fused"`` is refused.

Cluster tier, as in the reference: an engine can be one replica of a
:class:`~repro_torch.serving.cluster.ServingCluster`.  It then holds a
domain-bound view of the shared host store (``host=``), a cluster-wide
prefix index (``prefix_index=``), an ``engine_id`` naming its frame-lease
protection domain and the cluster's fault injector (``injector=``); the
replicas share one :class:`LM` (``params`` may be an ``LM``, held without
copying).  ``export_preempted`` / ``import_preempted`` hand a swapped-out
request to another replica with zero re-prefill; ``prestage_queued`` /
``cancel_prestage`` fault a queued request's reusable pages toward this
engine before admission.  Pages the shared tier spilled to disk are
promoted before they are read (the modeled disk stall is exposed time); a
request whose payloads a spill quarantine destroyed restarts from its
prompt, and a cache hit whose prefix was destroyed falls back to full
prefill.  A non-dense replica attached to a shared index never parks into
it (``prefix_park_skipped``), and parks are refused while the tier's
write-back buffer is full (``prefix_park_refused``).  With ``translation=
"flat"`` or ``"radix"`` each decode step's page tables run through the
translation meter (:mod:`repro_torch.core.ptw`): observational, the tokens
and the clock are unchanged.  Promoted, migrated and cross-engine prefix
pages land in the pool through the ``page_scatter`` kernel like any other
fault-in.  The pools and the pool writes of prefill, decode, fault-in and
compaction are updated in place.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, PoolGeometry
from repro_torch.core.cocoa import OutOfMemory
from repro_torch.core.demand_paging import LinkModel
from repro_torch.core.ptw import TranslationMeter
from repro_torch.kernels import ops as kops
from repro_torch.models.lm import LM
from repro_torch.models.page_ops import PageCtx
from repro_torch.serving.dma import (AsyncDMAEngine, DMAJob, Key, Prefetcher,
                                     StagingBuffer)
from repro_torch.serving import spans
from repro_torch.serving.host_tier import HostPageStore, PrefixIndex
from repro_torch.serving.kv_cache import ShardedKVCache
from repro_torch.serving.page_ring import PageRing


@dataclasses.dataclass
class Request:
    rid: int
    tenant: int
    prompt: np.ndarray           # int32 [T]
    max_new: int
    priority: int = 0            # higher = more important (preempt lowest)
    # SLO deadline on the engine's modeled µs clock: among same-priority
    # candidates, tighter slack is admitted first.  None = best-effort.
    deadline_us: Optional[float] = None
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    preemptions: int = 0


@dataclasses.dataclass
class EngineStats:
    prefill_tokens: int = 0
    decode_steps: int = 0
    decode_tokens: int = 0
    compaction_copies: int = 0
    wall_s: float = 0.0
    coalesced_sum: float = 0.0   # running sum of per-step coalesced fraction
    # Host-tier demand paging, modeled by the link model (as the reference).
    faults: int = 0              # base pages faulted in
    fault_dmas: int = 0          # DMA descriptors (contiguous runs)
    fault_steps: int = 0         # engine steps that faulted at all
    bytes_in: int = 0
    transfer_us: float = 0.0
    swaps_out: int = 0           # whole-request preemptions
    swaps_in: int = 0            # whole-request resumes
    # Async fault-in pipeline, modeled µs.
    fault_exposed_us: float = 0.0   # transfer µs the engine stalled on
    fault_hidden_us: float = 0.0    # transfer µs overlapped with decode
    prefetch_hits: int = 0          # faults served from staging/in-flight
    prefetch_misses: int = 0        # demand faults the prefetcher missed
    prefetch_wasted: int = 0        # prefetched pages never consumed
    # Full-duplex outbound DMA (eviction gathers), modeled.
    evict_pages: int = 0
    evict_dmas: int = 0
    bytes_out: int = 0
    evict_us: float = 0.0
    # Fused gather-attend decode: staged pages read by decode that had
    # landed when its window opened (ready) or arrived inside it
    # (drained), and the µs stalled on transfer tails past the window.
    fused_ready_pages: int = 0
    fused_drained_pages: int = 0
    fused_tail_us: float = 0.0
    # Prefix-cache reuse, as the reference.
    prefix_hits: int = 0            # admissions that matched a cached prefix
    prefix_misses: int = 0          # cache-enabled admissions with no match
    prefix_reused_tokens: int = 0   # prompt tokens NOT re-prefilled
    prefix_parked_pages: int = 0    # pages parked into the index
    prefix_fault_us: float = 0.0    # modeled µs to fault reused prefixes in
    admit_hits: int = 0             # admissions via the suffix-prefill path
    admit_colds: int = 0            # admissions via the full-prefill path
    admit_hit_us: float = 0.0       # wall µs spent in cache-hit admissions
    admit_cold_us: float = 0.0      # wall µs spent in cold admissions
    # Per-admission modeled latency samples (µs): prefilled tokens x
    # prefill_us_per_token.
    admit_lat_us: List[float] = dataclasses.field(default_factory=list)
    # Measured on this engine's device (host clock around synchronised
    # work), each fed by the phase span of the same region
    # (:mod:`repro_torch.serving.spans`): wall_s by serve.step, prefill_s
    # by serve.prefill_fwd, decode_s by serve.decode, d2h_s by serve.d2h,
    # h2d_s by serve.h2d, prefix_h2d_s by serve.prefix_h2d and
    # admit_hit_us / admit_cold_us by serve.prefill.
    prefill_s: float = 0.0       # prefill forwards, argmax included
    decode_s: float = 0.0        # decode forwards, argmax included
    d2h_bytes: int = 0           # eviction payloads copied off the device
    d2h_s: float = 0.0
    h2d_bytes: int = 0           # fault-in payloads copied onto the device
    h2d_s: float = 0.0
    landings: int = 0            # page_scatter batches (K and V launch each)
    gathers: int = 0             # page_gather batches (ring chunks): evictions
                                 # and parks
    xfer_chunks: int = 0         # chunks the page ring moved, both ways
    prefix_h2d_bytes: int = 0    # cached prefix KV copied up for attention
    prefix_h2d_s: float = 0.0
    fused_steps: int = 0         # decode steps that read staged pages
    # Cluster tier, as the reference: parks a non-dense replica skipped
    # (shared index) or the tier refused (write-back back-pressure),
    # admissions that promoted spilled frames and their modeled disk
    # stall, migrations, restarts after a spill quarantine, cache hits
    # that fell back to full prefill, pre-staging, and the translation
    # meter's lookups, walks and modeled µs.
    prefix_park_skipped: int = 0
    prefix_park_refused: int = 0
    promotions: int = 0
    promote_stall_us: float = 0.0
    migrations_out: int = 0
    migrations_in: int = 0
    lost_restarts: int = 0
    prefix_rederives: int = 0
    prestaged_pages: int = 0
    prestage_hits: int = 0
    prestage_wasted: int = 0
    prestage_cancelled: int = 0
    prestage_refund_us: float = 0.0
    translation_lookups: int = 0
    translation_tlb_hits: int = 0
    translation_walks: int = 0
    translation_walk_cycles: float = 0.0
    translation_queue_cycles: float = 0.0
    translation_us: float = 0.0
    deadline_hits: Dict[int, int] = dataclasses.field(default_factory=dict)
    deadline_misses: Dict[int, int] = dataclasses.field(default_factory=dict)

    def note_deadline(self, priority: int, hit: bool) -> None:
        d = self.deadline_hits if hit else self.deadline_misses
        d[priority] = d.get(priority, 0) + 1

    def slo_attainment(self, priority: Optional[int] = None
                       ) -> Optional[float]:
        """Fraction of deadline-carrying completions that met their
        deadline, overall or for one priority tier (None when none)."""
        if priority is None:
            hits = sum(self.deadline_hits.values())
            total = hits + sum(self.deadline_misses.values())
        else:
            hits = self.deadline_hits.get(priority, 0)
            total = hits + self.deadline_misses.get(priority, 0)
        return None if total == 0 else hits / total

    @property
    def coalesced_mean(self) -> float:
        return self.coalesced_sum / max(self.decode_steps, 1)

    def admit_hit_mean_us(self) -> float:
        return self.admit_hit_us / max(self.admit_hits, 1)

    def admit_cold_mean_us(self) -> float:
        return self.admit_cold_us / max(self.admit_colds, 1)

    def tok_per_s(self) -> float:
        if self.wall_s <= 0.0:
            return 0.0
        return (self.prefill_tokens + self.decode_tokens) / self.wall_s

    def summary(self) -> str:
        """One-line summary: throughput, the modeled fault split and
        prefetch and outbound counts, measured PCIe traffic, swaps, CAC
        copies and prefix-reuse totals."""
        line = (
            f"{self.tok_per_s():.1f} tok/s | "
            f"{self.prefill_tokens} prefill + {self.decode_tokens} decode "
            f"tok in {self.decode_steps} steps | "
            f"faults {self.faults} in {self.fault_dmas} DMAs "
            f"({self.bytes_in / 1024:.0f} KiB, "
            f"{self.fault_hidden_us:.0f}us hidden / "
            f"{self.fault_exposed_us:.0f}us exposed, modeled) | "
            f"prefetch {self.prefetch_hits}/{self.prefetch_misses}/"
            f"{self.prefetch_wasted} hit/miss/wasted | "
            f"out {self.evict_pages} pages in {self.evict_dmas} DMAs "
            f"({self.bytes_out / 1024:.0f} KiB, modeled) | "
            f"PCIe in {self.h2d_bytes / 2**20:.1f} MiB "
            f"{self.h2d_s * 1e3:.1f} ms, out {self.d2h_bytes / 2**20:.1f} MiB "
            f"{self.d2h_s * 1e3:.1f} ms | "
            f"swaps {self.swaps_out}/{self.swaps_in} | "
            f"CAC copies {self.compaction_copies}")
        if self.prefix_hits or self.prefix_misses:
            line += (f" | prefix {self.prefix_hits}/{self.prefix_misses} "
                     f"hit/miss ({self.prefix_reused_tokens} tok reused)")
        if self.prefix_park_skipped:
            line += f" | parks skipped {self.prefix_park_skipped} (non-dense)"
        if self.prefix_park_refused:
            line += (f" | parks refused {self.prefix_park_refused} "
                     f"(wb back-pressure)")
        if self.promotions:
            line += (f" | promotes {self.promotions} "
                     f"({self.promote_stall_us:.0f}us stall, modeled)")
        if self.migrations_out or self.migrations_in:
            line += (f" | migrated {self.migrations_out} out / "
                     f"{self.migrations_in} in")
        if self.lost_restarts or self.prefix_rederives:
            line += (f" | quarantine: {self.lost_restarts} restarts, "
                     f"{self.prefix_rederives} prefix re-derives")
        if self.fused_ready_pages or self.fused_drained_pages:
            line += (f" | fused {self.fused_ready_pages} ready + "
                     f"{self.fused_drained_pages} drained in-kernel "
                     f"({self.fused_tail_us:.0f}us tail, modeled)")
        if self.prestaged_pages:
            line += (f" | prestage {self.prestaged_pages} pages "
                     f"({self.prestage_hits}/{self.prestage_wasted}/"
                     f"{self.prestage_cancelled} hit/wasted/cancelled)")
        if self.translation_lookups:
            line += (f" | translation {self.translation_lookups} lookups, "
                     f"{self.translation_walks} walks "
                     f"({self.translation_us:.0f}us modeled, queue "
                     f"{self.translation_queue_cycles:.0f} cyc)")
        att = self.slo_attainment()
        if att is not None:
            tiers = sorted(set(self.deadline_hits) | set(self.deadline_misses),
                           reverse=True)
            per = ", ".join(
                f"t{t} {self.deadline_hits.get(t, 0)}/"
                f"{self.deadline_hits.get(t, 0) + self.deadline_misses.get(t, 0)}"
                for t in tiers)
            line += f" | SLO {att:.1%} ({per})"
        return line


class ServingEngine:
    """The reference's ``ServingEngine`` for one engine, in all three fault
    modes (``fault_mode="async"`` by default, as the reference).

    Keyword names match the reference's constructor.  ``params`` is a
    ``state_dict`` for :class:`~repro_torch.models.lm.LM` (for example from
    :func:`repro_torch.bridge.params_from_jax`), or an ``LM`` of this config
    on this device, which the engine holds without copying (cluster
    replicas share one); None draws the weights from ``torch.Generator``
    seeded with ``seed``.  ``self.params`` is the engine's ``LM``.
    ``device`` defaults to ``cuda`` and raises when CUDA is absent;
    ``device="cpu"`` runs every kernel's plain version.  ``dma_channels``, ``prefetch_depth``,
    ``duplex`` and ``slo_urgency_us`` shape the async/fused pipeline as in
    the reference.  ``prefix_cache`` (default True, as the reference) parks
    finished prompts in a :class:`PrefixIndex` of ``prefix_capacity_pages``
    pages and prefills only the suffix of a prompt whose page-aligned
    prefix is cached; ``prefill_us_per_token`` prices the modeled
    admission latencies.  ``host``, ``prefix_index``, ``engine_id`` and
    ``injector`` make the engine a cluster replica (module docstring);
    ``translation`` (``"off"``, ``"flat"``, ``"radix"``) and
    ``translation_kw`` configure the translation meter.  ``use_pallas`` is
    accepted for signature parity and has no effect.
    """

    def __init__(self, cfg: ModelConfig, *, geometry: PoolGeometry,
                 max_batch: int, max_seq: int, manager_kind: str = "mosaic",
                 n_shards: int = 1, params: Optional[Mapping] = None,
                 seed: int = 0, use_pallas: bool = False,
                 oversubscription: float = 1.0,
                 link: Optional[LinkModel] = None,
                 fault_mode: str = "async", dma_channels: int = 2,
                 prefetch_depth: int = 2, victim_policy: str = "cost",
                 decode_window_us: Optional[float] = None,
                 prefill_us_per_token: float = 50.0,
                 prefix_cache: bool = True,
                 prefix_capacity_pages: int = 4096,
                 duplex: bool = True,
                 slo_urgency_us: float = 1000.0,
                 host: Optional[HostPageStore] = None,
                 prefix_index: Optional[PrefixIndex] = None,
                 engine_id: int = 0,
                 injector=None,
                 translation: str = "off",
                 translation_kw: Optional[dict] = None,
                 device=None):
        if fault_mode not in ("async", "sync", "fused"):
            raise ValueError(
                f"fault_mode must be 'async', 'sync' or 'fused', "
                f"got {fault_mode!r}")
        if fault_mode == "fused" and cfg.mla is not None:
            # The fused path stages dense (k, v) page payloads into the
            # attention kernel; MLA's latent pools cannot consume them.
            raise ValueError("fault_mode='fused' supports dense-attention "
                             "families only (not MLA)")
        if victim_policy not in ("cost", "priority"):
            raise ValueError(
                f"victim_policy must be 'cost' or 'priority', "
                f"got {victim_policy!r}")
        if translation not in ("off", "flat", "radix"):
            raise ValueError(
                f"translation must be 'off', 'flat' or 'radix', "
                f"got {translation!r}")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run the "
                "kernels' plain versions")
        self.cfg = cfg
        # Replica identity within a cluster: the host-tier frame-lease
        # protection domain and the reporting label.
        self.engine_id = engine_id
        # False after an injected crash: the router stops dispatching here.
        self.alive = True
        self.injector = injector
        self.fault_mode = fault_mode
        self.victim_policy = victim_policy
        # Eviction gathers ride the channels' "out" lanes; only the async
        # pipeline has a channel timeline to ride.
        self.duplex = duplex and fault_mode in ("async", "fused")
        # Deadline slack below which a resume candidate counts as urgent
        # for SLO-aware prefetch-depth planning.
        self.slo_urgency_us = slo_urgency_us
        # Modeled compute window per decode step (µs) for the engine clock;
        # None = measured decode wall time.
        self.decode_window_us = decode_window_us
        # Modeled prefill compute per prompt token (µs): the basis of the
        # per-admission latency samples (admit_lat_us).
        self.prefill_us_per_token = prefill_us_per_token
        if isinstance(params, LM):
            # A cluster's replicas share one set of weights on the card.
            if params.cfg != cfg or any(p.device.type != self.device.type
                                        for p in params.parameters()):
                raise ValueError("a shared LM must have this engine's "
                                 "config and device")
            self.lm = params
        else:
            self.lm = LM(cfg, device=self.device)
            if params is None:
                gen = torch.Generator(device=self.device).manual_seed(seed)
                self.lm.init_weights(gen)
            else:
                self.lm.load_state_dict(params)
        self.params = self.lm
        self.geo = geometry
        self.max_batch = max_batch
        self.max_seq = max_seq
        pages_per_seq = (max_seq + geometry.page_tokens - 1) \
            // geometry.page_tokens
        self.mpps = int(np.ceil(pages_per_seq / n_shards
                                / geometry.frame_pages)
                        ) * geometry.frame_pages
        # oversubscription > 1 shrinks the pool below the sized-for-peak
        # working set; the host tier absorbs the overflow.  Sizing is the
        # reference's, so both engines' managers see the same geometry.
        per_shard = int(geometry.pages_for(max_seq, max_batch) / n_shards
                        / max(oversubscription, 1e-9))
        per_shard = max(per_shard, self.mpps)  # ≥ one max-length sequence
        per_shard = ((per_shard + geometry.frame_pages - 1)
                     // geometry.frame_pages) * geometry.frame_pages
        probe = self.lm.pool_shapes(1, geometry.page_tokens)
        # True KV bytes of one base page across all layers (k + v); 0 for
        # the attention-free ssm family (the managers then model the
        # paper's nominal page size).
        self.page_bytes = sum(int(np.prod(shape[2:])) * shape[0]
                              * dtype.itemsize for shape, dtype in probe) \
            if probe else 0
        self.link = link or LinkModel()
        self.cache = ShardedKVCache(geometry, per_shard, n_shards,
                                    manager_kind, link=self.link,
                                    page_bytes=self.page_bytes)
        # ``host`` may be a cluster-shared store view; a standalone engine
        # owns a private store.
        self.host = host if host is not None else HostPageStore()
        # Content-hash prefix cache.  Suffix-only prefill needs attention
        # over cached KV pages, which only the dense-transformer family
        # replays bitwise (the reference's condition: ssm and hybrid carry
        # recurrent state that cached KV cannot restore, vlm an image
        # prefix and encdec cross K/V that the pages do not hold).
        self.prefix_supported = (cfg.family == "dense" and cfg.mla is None
                                 and bool(self.page_bytes))
        self.prefix: Optional[PrefixIndex] = None
        if prefix_index is not None:
            # Cluster-shared index: kept even when this replica's family
            # cannot replay cached KV; match and park skip (and count).
            self.prefix = prefix_index if prefix_cache else None
        elif prefix_cache and self.prefix_supported:
            self.prefix = PrefixIndex(self.host, geometry.page_tokens,
                                      capacity_pages=prefix_capacity_pages)
        shapes = self.lm.pool_shapes(per_shard * n_shards,
                                     geometry.page_tokens)
        self.pools = (tuple(torch.zeros(shape, dtype=dtype,
                                        device=self.device)
                            for shape, dtype in shapes)
                      if shapes else None)
        # Gathers to and fault-in landings from the host store move in
        # chunks of one frame through page-locked slots
        # (:mod:`repro_torch.serving.page_ring`).
        self._ring = (PageRing(self.pools, geometry.frame_pages)
                      if self.pools is not None else None)
        # Per-request decode state (ssm / hybrid: {"ssm", "conv"}; encdec:
        # {"cross_k", "cross_v"}; each with a batch axis of 1), kept on the
        # device across preemption: only KV pages swap.
        self.states: Dict[int, Dict[str, torch.Tensor]] = {}
        self.queue: Deque[Request] = deque()
        self.preempted: Deque[Request] = deque()
        self._held: List[Request] = []
        self._saved_tokens: Dict[int, int] = {}
        self.active: List[Request] = []
        # rids migrated away to another engine: their in-flight prefetch
        # payloads settle as waste here, never re-stage.
        self._foreign: set = set()
        self._stalled_steps = 0      # consecutive no-decode steps
        self.stats = EngineStats()
        # Async fault-in pipeline: DMA channel timeline, double-buffered
        # staging and next-step touch predictor, on the modeled µs clock
        # (advanced by the decode window and by exposed stalls).
        self.dma = AsyncDMAEngine(self.link, n_channels=dma_channels,
                                  duplex=duplex, injector=injector)
        self.staging = StagingBuffer()
        self.prefetch = Prefetcher(depth=prefetch_depth)
        # Keys pre-staged toward this engine for still-queued requests,
        # mapped to the source page's owner id (prefix owners are never
        # reused, so a matching owner proves the staged bytes are the ones
        # admission would fetch).
        self._prestage_keys: Dict[Key, int] = {}
        # Translation meter: the decode loop feeds it the KV page tables
        # each step's batch reads; the subregion span is the allocator's
        # frame, so an unsplintered frame is one TLB entry.
        self.translation = translation
        self.translation_meter: Optional[TranslationMeter] = None
        if translation != "off":
            self.translation_meter = TranslationMeter(
                translation, span=max(1, geometry.frame_pages),
                **(translation_kw or {}))
        self._clock_us = 0.0
        # Fused decode step state: DMA jobs this step's decode consumes
        # (settled at the window end), the staged ((shard, ppn), payload,
        # arrive_us) entries awaiting the post-decode scatter, their copy
        # on the device once decode has read it, and the window-open time.
        self._fused_jobs: List[DMAJob] = []
        self._fused_staged: List[tuple] = []
        self._fused_stage: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._fused_t0 = 0.0

    # ------------------------------------------------------------- helpers

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _span(self, name: str, stat: Optional[str] = None) -> spans.span:
        """A phase span of this engine; ``stat`` names the
        :class:`EngineStats` field that also takes its seconds."""
        return spans.span(name, stat, self.stats)

    def _index(self, ids: List[int]) -> torch.Tensor:
        return torch.tensor(ids, dtype=torch.int32, device=self.device)

    # ------------------------------------------------------------- admission

    def submit(self, req: Request):
        self.queue.append(req)

    def _slack(self, r: Request) -> Optional[float]:
        """Deadline slack on the modeled clock (None = no deadline)."""
        if r.deadline_us is None:
            return None
        return r.deadline_us - self._clock_us

    def _slack_or_inf(self, r: Request) -> float:
        s = self._slack(r)
        return float("inf") if s is None else s

    def _admit(self):
        # One admission order across resumes and new arrivals: highest
        # priority first; within a tier, tightest deadline first
        # (deadline-free requests rank last and stay FIFO — max() is
        # stable), and resumes beat arrivals.
        def rank(r: Request):
            return (r.priority, -self._slack_or_inf(r))

        skipped: set = set()     # failed this round; don't block the rest
        while True:
            cand = max((r for r in self.preempted
                        if r.rid not in skipped),
                       key=rank, default=None)
            queued = max((r for r in self.queue if r.rid not in skipped),
                         key=rank, default=None)
            resume = cand is not None and (
                queued is None or cand.priority >= queued.priority)
            if not resume:
                cand = queued
            if cand is None:
                break
            if len(self.active) >= self.max_batch:
                # A premium candidate displaces a strictly-lower-priority
                # active request; with no such victim, stop the round.
                victim = self._pick_victim(below_priority=cand.priority)
                if victim is None:
                    break
                self._preempt(victim)
            spans.count("admit_tries")
            ok = self._resume(cand) if resume else self._admit_one(cand)
            if not ok:
                spans.count("admit_refused")
                skipped.add(cand.rid)
                continue
            (self.preempted if resume else self.queue).remove(cand)
            self.active.append(cand)
        if not self.active and (self.queue or self.preempted):
            raise RuntimeError(
                "pool cannot hold a single request: shrink max_seq or grow "
                "the pool (oversubscription too aggressive)")

    # --------------------------------------------------- preemption / resume

    def _victim_score(self, r: Request) -> float:
        """Cost of evicting ``r``: resident pages × (priority + 1) ×
        remaining tokens.  Lower = better victim."""
        remaining = max(r.max_new - len(r.out), 1)
        return (float(self.cache.resident_page_count(r.rid))
                * (r.priority + 1) * remaining)

    def _pick_victim(self, *, below_priority: Optional[int] = None,
                     exclude: Tuple[int, ...] = ()) -> Optional[Request]:
        """Cheapest-to-evict active request under the configured policy,
        below ``below_priority`` when given; ties go youngest-first."""
        cands = [r for r in self.active if r.rid not in exclude]
        if below_priority is not None:
            cands = [r for r in cands if r.priority < below_priority]
        if not cands:
            return None
        if self.victim_policy == "priority":
            return min(cands, key=lambda r: (r.priority, -r.rid))
        return min(cands,
                   key=lambda r: (self._victim_score(r), r.priority, -r.rid))

    def _alloc_with_preemption(self, req: Request, n_tokens: int, *,
                               below_priority: Optional[int],
                               exclude: Tuple[int, ...] = ()) -> bool:
        """Allocate with growth headroom, preempting victims as needed.

        An allocation that succeeds but leaves no room for one decode step
        of the batch evicts another victim and retries, so victims are only
        swapped out on a path that ends in admission.  Returns False
        (leaving ``req`` unallocated) when no victim remains.
        """
        with self._span("serve.alloc"):
            while True:
                try:
                    self.cache.allocate(req.rid, n_tokens)
                except OutOfMemory:
                    # Roll back the partial allocation.
                    self.cache.free(req.rid)
                    victim = self._pick_victim(below_priority=below_priority,
                                               exclude=exclude + (req.rid,))
                    if victim is None:
                        return False
                    self._preempt(victim)
                    continue
                if self._growth_guard_ok(req):
                    return True
                self.cache.free(req.rid)
                victim = self._pick_victim(below_priority=below_priority,
                                           exclude=exclude + (req.rid,))
                if victim is None:
                    return False
                self._preempt(victim)

    def _gather_pages(self, entries: List[Tuple[int, int, int]]
                      ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Device→host gather of [(shard, vpn, ppn)] pool pages (an
        eviction or a park) through the page ring: per chunk one kernel
        launch per pool over all layers and one copy to the host.
        Returns per-page (k_page, v_page) CPU payloads (none without
        pools)."""
        if not entries or self.pools is None:
            return []
        pps = self.cache.pages_per_shard
        gidx = self._index([s * pps + ppn for s, _v, ppn in entries])
        self._sync()
        with self._span("serve.d2h", "d2h_s"):
            (kp, vp), chunks = self._ring.gather(gidx)  # [L, n, ptok, ...]
        self.stats.d2h_bytes += kp.nbytes + vp.nbytes
        self.stats.gathers += chunks
        self._count_chunks(chunks)
        return [(kp[:, i], vp[:, i]) for i in range(len(entries))]

    def _count_chunks(self, chunks: int) -> None:
        self.stats.xfer_chunks += chunks
        spans.count("xfer_chunks", chunks)

    def _enqueue_outbound(self, keys: List[Key],
                          entries: List[Tuple[int, int, int]],
                          payloads: List[Tuple[torch.Tensor, torch.Tensor]],
                          kind: str) -> None:
        """Account a device→host gather on the DMA channels' "out" lanes
        (full duplex).  The host copy is synchronous in the model, so the
        engine never stalls on these jobs: they occupy the outbound
        timeline and settle as hidden µs at the next drain.  Without pools
        (ssm) a gather moves nothing and no job is queued."""
        if not self.duplex or not entries or self.pools is None:
            return
        by_shard: Dict[int, List[int]] = {}
        for i, (s, _vpn, _ppn) in enumerate(entries):
            by_shard.setdefault(s, []).append(i)
        for s, idxs in sorted(by_shard.items()):
            job = self.dma.enqueue(
                [keys[i] for i in idxs],
                [entries[i][2] for i in idxs],
                self.cache.mgrs[s].residency.page_bytes,
                [payloads[i] for i in idxs],
                self._clock_us, kind=kind, direction="out")
            self.stats.evict_pages += len(job.keys)
            self.stats.evict_dmas += job.dma_count
            self.stats.bytes_out += job.nbytes
            self.stats.evict_us += job.transfer_us

    def _preempt(self, victim: Request) -> None:
        """Swap a request out: resident pages → host store at base-page
        granularity, pages freed for other tenants."""
        with self._span("serve.preempt"):
            rid = victim.rid
            # Pending compaction plans rewrote tables already; land the
            # payload copies before gathering through those tables.
            self._run_compaction()
            pages = self.cache.mapped_pages(rid)     # [(shard, vpn, ppn)]
            # A just-resumed victim may still hold non-resident pages whose
            # payloads never left the host store: gather only resident ones.
            resident = [
                (s, vpn, ppn) for s, vpn, ppn in pages
                if self.cache.mgrs[s].residency.resident[ppn]
            ]
            payloads = self._gather_pages(resident)
            for (s, vpn, _ppn), (kp, vp) in zip(resident, payloads):
                self.host.put(rid, s, vpn, kp, vp)
            # The gather is outbound DMA traffic on the channels' "out"
            # lanes.
            self._enqueue_outbound(
                [(rid, s, vpn) for s, vpn, _p in resident], resident,
                payloads, kind="evict")
            self.cache.evict_pages(resident)
            self._saved_tokens[rid] = self.cache.seq_tokens[rid]
            self.cache.free(rid)
            self.active.remove(victim)
            victim.preemptions += 1
            self.preempted.append(victim)
            self.host.note_swap_out()
            self.stats.swaps_out += 1

    def preempt(self, rid: int, *, hold: bool = False) -> bool:
        """Proactively swap an active request out.  It resumes when
        capacity allows, unless ``hold`` is set — a held request stays
        swapped out until :meth:`release`.  False if ``rid`` is not
        active."""
        for r in self.active:
            if r.rid == rid:
                self._preempt(r)
                if hold:
                    self.preempted.remove(r)
                    self._held.append(r)
                return True
        return False

    def release(self, rid: int) -> bool:
        """Make a held request eligible for resume again."""
        for r in self._held:
            if r.rid == rid:
                self._held.remove(r)
                self.preempted.append(r)
                return True
        return False

    # ------------------------------------------------- cross-engine handoff

    def export_preempted(self, rid: int) -> Optional[dict]:
        """Detach a preempted request for migration to another engine.
        It is fully swapped out (preemption gathers every resident page to
        the host store), so the bundle is the Request, its decode state
        and its saved token count; its pages stay in the shared store and
        the cluster re-leases their frames to the destination.  Local
        staging and prefetch state for the rid is invalidated, and
        in-flight payloads settle as waste."""
        for r in self.preempted:
            if r.rid == rid:
                break
        else:
            return None
        self.preempted.remove(r)
        bundle = {"request": r, "state": self.states.pop(rid, None),
                  "saved_tokens": self._saved_tokens.pop(rid)}
        self._note_prestage_waste(rid)
        dropped = self.staging.invalidate_seq(rid)
        self.stats.prefetch_wasted += dropped
        self.prefetch.stats["wasted_pages"] += dropped
        self.prefetch.cancel_seq(rid)
        self._foreign.add(rid)
        self.stats.migrations_out += 1
        return bundle

    def import_preempted(self, bundle: dict) -> None:
        """Adopt a migrated request: it joins this engine's resume queue
        and faults its pages in from the shared host store through this
        engine's own DMA lanes and ``page_scatter``: no device-to-device
        copy and no re-prefill."""
        r = bundle["request"]
        self._foreign.discard(r.rid)
        self.preempted.append(r)
        if bundle["state"] is not None:
            self.states[r.rid] = bundle["state"]
        self._saved_tokens[r.rid] = bundle["saved_tokens"]
        self.stats.migrations_in += 1

    # ------------------------------------------------ proactive pre-staging
    # The router calls these for queued, never-admitted requests: once a
    # target engine is picked, the request's prefix-index hits and resume
    # pages start faulting toward this engine's staging buffers over the
    # prefetch lanes.  Timing only: the probe is read-only (``peek_match``)
    # and the staged payloads are the bytes admission would fetch.

    def prestage_queued(self, req: Request) -> int:
        """Fault ``req``'s known-reusable pages toward staging before its
        admission step; returns the number of pages issued.

        Two sources: host copies the rid already owns and prefix-index
        hits, staged under the exact ``(rid, shard, vpn)`` keys
        :meth:`_prefill_suffix` will enqueue, so admission dedups against
        them.  Spilled frames are promoted here, but the promote stall is
        not charged to this engine's clock: it is background work on the
        tier's disk lanes."""
        if self.fault_mode not in ("async", "fused") or not self.alive:
            return 0
        keys: List[Key] = []
        srcs: List[Key] = []
        for key in self.host.seq_pages(req.rid):
            if self.staging.contains(key) or key in self.prefetch.in_flight:
                continue
            keys.append(key)
            srcs.append(key)
        if self.prefix is not None and self.prefix_supported:
            ptok = self.geo.page_tokens
            n, pages = self.prefix.peek_match(req.prompt)
            n = min(n, (len(req.prompt) - 1) // ptok)
            for pg in pages[:n]:
                key = (req.rid, pg.shard, pg.vpn)
                if self.staging.contains(key) \
                        or key in self.prefetch.in_flight:
                    continue
                keys.append(key)
                srcs.append((pg.owner, pg.shard, pg.vpn))
        if not keys:
            return 0
        # Promote spilled source frames now (off the admission path); a
        # quarantine may destroy sources: drop those from the batch.
        self.host.ensure_resident(srcs, now_us=self._clock_us)
        live = [(k, src) for k, src in zip(keys, srcs)
                if self.host.has(*src)]
        if not live:
            return 0
        keys = [k for k, _ in live]
        payloads = [self.host.peek(*src) for _, src in live]
        if any(p is None for p in payloads):
            return 0
        job = self.dma.enqueue(keys, list(range(len(keys))),
                               self.page_bytes, payloads, self._clock_us,
                               kind="prefetch")
        self._account_prefetch(job)
        for k, src in live:
            self._prestage_keys[k] = src[0]     # source owner fingerprint
        self.stats.prestaged_pages += len(keys)
        return len(keys)

    def cancel_prestage(self, rid: int) -> float:
        """Cancel ``rid``'s pre-staged pages (a steal or a crash
        retargeted the request before admission).  In-flight jobs whose
        pages are all pre-stage work for this rid are cancelled with a
        lane-time refund for the un-elapsed remainder; payloads already
        staged are dropped.  Returns the refunded µs."""
        refunded = 0.0
        jobs: Dict[int, DMAJob] = {}
        for key, job in list(self.prefetch.in_flight.items()):
            if key[0] == rid and key in self._prestage_keys:
                jobs[job.job_id] = job
        for job in jobs.values():
            if not all(k[0] == rid and k in self._prestage_keys
                       for k in job.keys):
                continue            # mixed job: let it settle normally
            refunded += self.dma.cancel(job, self._clock_us)
            self.prefetch.forget(job.keys)
            self.stats.prestage_cancelled += len(job.keys)
            for k in job.keys:
                self._prestage_keys.pop(k, None)
        mine = [k for k in self._prestage_keys if k[0] == rid]
        if mine:
            for k in mine:
                self._prestage_keys.pop(k, None)
            self.stats.prestage_cancelled += \
                self.staging.invalidate_seq(rid)
        self.prefetch.cancel_seq(rid)
        self.stats.prestage_refund_us += refunded
        self.stats.transfer_us = max(0.0, self.stats.transfer_us - refunded)
        return refunded

    def _note_prestage_hit(self, key: Key) -> None:
        if self._prestage_keys.pop(key, None) is not None:
            self.stats.prestage_hits += 1

    def _note_prestage_waste(self, rid: int) -> None:
        """Account pre-staged pages the request never consumed (counted
        at the same invalidation points as prefetch waste)."""
        stale = [k for k in self._prestage_keys if k[0] == rid]
        for k in stale:
            self._prestage_keys.pop(k, None)
            self.stats.prestage_wasted += 1

    def _free_pages_total(self) -> int:
        return sum(m.config.num_pages - int(m.pool.page_allocated.sum())
                   for m in self.cache.mgrs)

    def _growth_guard_ok(self, req: Request) -> bool:
        """Admitting ``req`` must leave room for ≥ one decode step of the
        whole batch (else resume↔preempt livelock)."""
        if not self.active:
            return True          # a sole request always fits (pool ≥ mpps)
        return self._free_pages_total() >= len(self.active) + 2

    def _resume(self, req: Request) -> bool:
        """Re-map a preempted request; payloads fault in on next touch.

        If the tier quarantined a spill frame holding this request's
        swapped-out payloads, the saved state is unusable: restart from
        the prompt instead (the deterministic decoder replays the same
        tokens)."""
        if self.host.take_lost(req.rid):
            self._forget_request(req)
            self.stats.lost_restarts += 1
            return self._admit_one(req)
        tokens = self._saved_tokens[req.rid]
        if not self._alloc_with_preemption(req, tokens,
                                           below_priority=req.priority):
            return False
        # Allocation under pressure may have planned compaction: execute the
        # copies before anything reads the rewritten tables.
        self._run_compaction()
        self.cache.demote_host_backed(req.rid, self.host)
        del self._saved_tokens[req.rid]
        self.host.note_swap_in()
        self.stats.swaps_in += 1
        return True

    def _forget_request(self, r: Request) -> None:
        """Erase every trace of a request whose saved payloads a spill
        quarantine destroyed, so it can restart from the prompt: device
        pages, decode state, host copies, staged and in-flight prefetches,
        saved token count, and the tokens already emitted."""
        self.cache.free(r.rid)
        self.states.pop(r.rid, None)
        self.host.drop_seq(r.rid)
        self.host.take_lost(r.rid)   # clear a flag re-set during the drop
        self._note_prestage_waste(r.rid)
        dropped = self.staging.invalidate_seq(r.rid)
        self.stats.prefetch_wasted += dropped
        self.prefetch.stats["wasted_pages"] += dropped
        self.prefetch.cancel_seq(r.rid)
        self._saved_tokens.pop(r.rid, None)
        r.out.clear()
        r.done = False

    def _restart_lost(self, rids: set) -> None:
        """Pull active requests whose payloads a quarantine destroyed out
        of the batch and re-queue them from the prompt (head of the
        queue: they are the oldest work)."""
        for r in [r for r in self.active if r.rid in rids]:
            self.active.remove(r)
            self._forget_request(r)
            self.queue.appendleft(r)
            self.stats.lost_restarts += 1

    def _admit_one(self, req: Request) -> bool:
        # vlm requests hold the image's frontend tokens in front of the
        # prompt in the pool.
        n_prefix = (self.cfg.frontend_tokens
                    if self.cfg.family == "vlm" else 0)
        if not self._alloc_with_preemption(req, n_prefix + len(req.prompt),
                                           below_priority=req.priority):
            return False
        self._prefill(req)
        return True

    # --------------------------------------------------- demand fault-in

    def _upload(self, payloads: List[Tuple[torch.Tensor, torch.Tensor]]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Copy host payloads to the device whole, as [L, n, ptok, n_kv,
        dh] K and V tensors: the fused path's step-local stage, which
        decode reads whole; timed."""
        kp = torch.stack([p[0] for p in payloads], dim=1)
        vp = torch.stack([p[1] for p in payloads], dim=1)
        self._sync()
        with self._span("serve.h2d", "h2d_s"):
            kp, vp = kp.to(self.device), vp.to(self.device)
            self._sync()
        self.stats.h2d_bytes += kp.nbytes + vp.nbytes
        return kp, vp

    def _land(self, idx: torch.Tensor, kp: torch.Tensor,
              vp: torch.Tensor) -> None:
        """Scatter device-resident pages into the pools at global page ids
        ``idx`` (int32 on the device): one kernel launch per pool over all
        layers."""
        with self._span("serve.land"):
            k, v = self.pools
            kops.page_scatter(k, idx, kp)
            kops.page_scatter(v, idx, vp)
        self.stats.landings += 1

    def _scatter_pages(self, gidx: List[int],
                       payloads: List[Tuple[torch.Tensor, torch.Tensor]]
                       ) -> None:
        """Land faulted host payloads in the device pools through the page
        ring: the host→device transfer of demand paging, timed from the
        first chunk's packing to the last chunk's landing."""
        if not gidx:
            return
        idx = self._index(gidx)
        self._sync()
        with self._span("serve.h2d", "h2d_s"):
            chunks = self._ring.scatter(idx, payloads, self._land)
            self._sync()
        self.stats.h2d_bytes += sum(k.nbytes + v.nbytes for k, v in payloads)
        self._count_chunks(chunks)

    def _fault_in(self, seqs: List[int]) -> set:
        """touch() this step's pages and fault the missing ones in: blocking
        under ``"sync"``, staged and overlapped under ``"async"``, resolved
        to decode-time sources under ``"fused"``.  Returns the rids whose
        payloads a spill quarantine destroyed during the promote: their
        entries were skipped and the caller restarts them."""
        if self.fault_mode == "sync":
            return self._fault_in_sync(seqs)
        if self.fault_mode == "fused":
            return self._fault_in_fused(seqs)
        return self._fault_in_async(seqs)

    @staticmethod
    def _drop_lost_entries(missing: Dict, lost: set) -> Dict:
        """Remove a lost rid's entries from a missing-pages map: their
        host payloads no longer exist, so they must not be popped."""
        if not lost:
            return missing
        return {s: kept for s, entries in missing.items()
                if (kept := [e for e in entries if e[1] not in lost])}

    def _promote_missing(self, missing: Dict) -> set:
        """Before popping payloads, promote any spilled frames the step's
        misses live in; the modeled disk-read stall is exposed time,
        charged to the clock like a demand fault.  Returns the rids whose
        payloads the promote destroyed (frame quarantine after corruption
        or a permanent disk error)."""
        keys = [(owner, s, vpn) for s, entries in missing.items()
                for _ppn, owner, vpn in entries]
        promote_us = self.host.ensure_resident(keys, now_us=self._clock_us)
        if promote_us:
            self._clock_us += promote_us
            self.stats.promote_stall_us += promote_us
            self.stats.promotions += 1
        return {k[0] for k in keys
                if k[0] >= 0 and self.host.take_lost(k[0])}

    def _fault_in_sync(self, seqs: List[int]) -> set:
        """The blocking path: the whole batch stalls on the transfer, so
        every µs is exposed."""
        missing = self.cache.missing_pages(seqs)
        if not missing:
            return set()
        lost = self._promote_missing(missing)
        missing = self._drop_lost_entries(missing, lost)
        if not missing:
            return lost
        pps = self.cache.pages_per_shard
        gidx: List[int] = []
        payloads: List[Tuple[torch.Tensor, torch.Tensor]] = []
        step_us = 0.0
        for s, entries in missing.items():
            batch = self.cache.mgrs[s].residency.fault_in(
                [ppn for ppn, _o, _v in entries])
            self.stats.faults += len(batch.ppns)
            self.stats.fault_dmas += batch.dma_count
            self.stats.bytes_in += batch.nbytes
            self.stats.transfer_us += batch.transfer_us
            self.stats.fault_exposed_us += batch.transfer_us
            step_us += batch.transfer_us
            for ppn, owner, vpn in entries:
                gidx.append(s * pps + ppn)
                payloads.append(self.host.pop(owner, s, vpn))
        self.stats.fault_steps += 1
        self._clock_us += step_us       # the whole transfer stalls the step
        self._scatter_pages(gidx, payloads)
        return lost

    def _consume_hit(self, s: int, ppn: int, key: Key) -> None:
        """Book a miss served by a staged or in-flight prefetch: the page
        is resident from now on and its host copy is retired."""
        self.cache.mgrs[s].residency.mark_resident([ppn])
        self.host.pop(*key)
        self.stats.faults += 1
        self.stats.prefetch_hits += 1
        self._note_prestage_hit(key)
        self.prefetch.stats["hits"] += 1

    def _demand(self, s: int, demand: List[Tuple[int, int, int]], now: float
                ) -> Tuple[DMAJob, List[Tuple[torch.Tensor, torch.Tensor]]]:
        """Fault the never-predicted misses of shard ``s`` in as one demand
        job on the channels (queued behind in-flight prefetches)."""
        self.cache.mgrs[s].residency.fault_in([ppn for ppn, _o, _v in demand])
        dpay = [self.host.pop(owner, s, vpn) for _ppn, owner, vpn in demand]
        job = self.dma.enqueue(
            [(owner, s, vpn) for _p, owner, vpn in demand],
            [ppn for ppn, _o, _v in demand],
            self.cache.mgrs[s].residency.page_bytes, dpay, now,
            kind="demand")
        self.stats.faults += len(demand)
        self.stats.fault_dmas += job.dma_count
        self.stats.bytes_in += job.nbytes
        self.stats.transfer_us += job.transfer_us
        self.stats.prefetch_misses += len(demand)
        self.prefetch.stats["misses"] += len(demand)
        return job, dpay

    def _restage_leftovers(self, waited: Dict[Key, tuple]) -> None:
        """Payloads of a waited multi-page job whose keys were not touched
        this step stay staged for later steps; a key whose owner retired
        (or migrated away) mid-flight is wasted transfer."""
        for key, payload in waited.items():
            if self.host.has(*key) and key[0] not in self._foreign:
                self.staging.stage(key, payload)
            else:
                self.prefetch.stats["wasted_pages"] += 1
                self.stats.prefetch_wasted += 1

    def _fault_in_async(self, seqs: List[int]) -> set:
        """Serve this step's misses from staging (hidden), stall on
        in-flight prefetches (partially hidden), and demand-fault only the
        never-predicted remainder (exposed).  The payloads then land
        through the same upload and scatter as sync mode."""
        missing = self.cache.missing_pages(seqs)
        if not missing:
            return set()
        lost = self._promote_missing(missing)
        missing = self._drop_lost_entries(missing, lost)
        pps = self.cache.pages_per_shard
        now = self._clock_us
        gidx: List[int] = []
        payloads: List[Tuple[torch.Tensor, torch.Tensor]] = []
        waited: Dict[Key, tuple] = {}
        for s, entries in sorted(missing.items()):
            demand: List[Tuple[int, int, int]] = []
            for ppn, owner, vpn in entries:
                key = (owner, s, vpn)
                payload = waited.pop(key, None)
                if payload is None:
                    payload = self.staging.consume(key)
                if payload is None and key in self.prefetch.in_flight:
                    # Started during the previous decode: stall only for
                    # the remainder of its transfer.
                    job = self.prefetch.in_flight[key]
                    now = self.dma.wait(job, now)
                    self.prefetch.forget(job.keys)
                    waited.update(zip(job.keys, job.payloads))
                    payload = waited.pop(key)
                if payload is None:
                    demand.append((ppn, owner, vpn))
                    continue
                self._consume_hit(s, ppn, key)
                gidx.append(s * pps + ppn)
                payloads.append(payload)
            if demand:
                job, dpay = self._demand(s, demand, now)
                now = self.dma.wait(job, now)
                for (ppn, _o, _v), p in zip(demand, dpay):
                    gidx.append(s * pps + ppn)
                    payloads.append(p)
        self._restage_leftovers(waited)
        self.stats.fault_steps += 1
        # Engine-level exposed = the step's stall (channel queueing
        # included); the DMA engine keeps the strict per-transfer split.
        self.stats.fault_exposed_us += now - self._clock_us
        self.stats.fault_hidden_us = self.dma.stats["hidden_us"]
        self._clock_us = now
        self._scatter_pages(gidx, payloads)
        return lost

    # ------------------------------------------------ fused decode path

    def _write_page_set(self, seqs: List[int]) -> set:
        """(shard, ppn) of each sequence's current write page, the page
        this step's token lands in.  A staged write page is merged into
        the pool before decode: attention would otherwise read the staged
        bytes without the new token."""
        ftok = self.geo.frame_pages * self.geo.page_tokens
        out = set()
        for seq in seqs:
            pos = self.cache.seq_tokens[seq] - 1
            s = self.cache._shard_of_frame(pos // ftok)
            table = self.cache.mgrs[s].tables[seq]
            out.add((s, table.ppn[len(table.ppn) - 1]))
        return out

    def _fault_in_fused(self, seqs: List[int]) -> set:
        """Resolve this step's misses to sources (staged payloads,
        in-flight prefetch jobs, fresh demand jobs) without waiting on any
        transfer.  Decode reads them from the step's stage
        (:meth:`_attach_staging`); the collected jobs settle against the
        end of the decode window (:meth:`_settle_fused`)."""
        self._fused_jobs = []
        self._fused_staged = []
        self._fused_stage = None
        self._fused_t0 = self._clock_us
        missing = self.cache.missing_pages(seqs)
        if not missing:
            return set()
        lost = self._promote_missing(missing)       # disk stall stays exposed
        missing = self._drop_lost_entries(missing, lost)
        self._fused_t0 = self._clock_us
        now = self._clock_us
        pps = self.cache.pages_per_shard
        write_pages = self._write_page_set(
            [s for s in seqs if s in self.cache.seq_tokens])
        jobs: Dict[int, DMAJob] = {}
        waited: Dict[Key, tuple] = {}
        arrive: Dict[Key, float] = {}
        for s, entries in sorted(missing.items()):
            demand: List[Tuple[int, int, int]] = []
            for ppn, owner, vpn in entries:
                key = (owner, s, vpn)
                when = now          # staging hits landed before this step
                payload = waited.pop(key, None)
                if payload is not None:
                    when = arrive.get(key, now)
                if payload is None:
                    payload = self.staging.consume(key)
                if payload is None and key in self.prefetch.in_flight:
                    # In flight: read in-kernel, do not stall; record the
                    # page's modeled arrival.
                    job = self.prefetch.in_flight[key]
                    jobs[job.job_id] = job
                    self.prefetch.forget(job.keys)
                    for i2, (k2, p2) in enumerate(
                            zip(job.keys, job.payloads)):
                        waited[k2] = p2
                        arrive[k2] = job.page_done_us(i2)
                    payload = waited.pop(key)
                    when = arrive[key]
                if payload is None:
                    demand.append((ppn, owner, vpn))
                    continue
                self._consume_hit(s, ppn, key)
                self._fused_staged.append(((s, ppn), payload, when))
            if demand:
                job, dpay = self._demand(s, demand, now)
                jobs[job.job_id] = job
                for i2, ((ppn, _o, _v), p) in enumerate(zip(demand, dpay)):
                    self._fused_staged.append(
                        ((s, ppn), p, job.page_done_us(i2)))
        self._restage_leftovers(waited)
        self._fused_jobs = sorted(jobs.values(), key=lambda j: j.job_id)
        # The write page lands now (this step's token write mutates it);
        # everything else stays staged for decode.  Its job still settles
        # at the window end.
        pre = [(sp, pl) for sp, pl, _t in self._fused_staged
               if sp in write_pages]
        if pre:
            self._scatter_pages([s * pps + p for (s, p), _pl in pre],
                                [pl for _sp, pl in pre])
            self._fused_staged = [e for e in self._fused_staged
                                  if e[0] not in write_pages]
        self.stats.fault_steps += 1
        return lost

    def _attach_staging(self, ctx: PageCtx) -> PageCtx:
        """Hand decode this step's staged pages: one host→device copy of
        their payloads as the stage [L, NS, ptok, n_kv, dh] (contiguous
        per layer), and a slot table shaped like ``ctx.tables`` (-1 = read
        the pool).  The reference pads NS to a power of two to bound jit
        retraces; eager PyTorch has none, so NS is exact."""
        if not self._fused_staged:
            return ctx
        pps = self.cache.pages_per_shard
        gidx = [s * pps + ppn for (s, ppn), _pl, _t in self._fused_staged]
        lut = torch.full((self.cache.S * pps,), -1, dtype=torch.int32)
        lut[torch.tensor(gidx)] = torch.arange(len(gidx), dtype=torch.int32)
        lut = lut.to(self.device)
        slots = torch.where(ctx.tables >= 0,
                            lut[ctx.tables.clamp(min=0).long()], -1)
        kp, vp = self._upload([pl for _sp, pl, _t in self._fused_staged])
        self._fused_stage = (kp, vp)
        self.stats.fused_steps += 1
        return dataclasses.replace(ctx, slots=slots.contiguous(),
                                   stage_k=kp, stage_v=vp)

    def _settle_fused(self) -> None:
        """Post-decode sync point: the collected jobs settle against the
        window end (transfer µs inside the window are hidden, tails past
        it exposed), then the staged pages are scattered into the pool
        from the copy :meth:`_attach_staging` put on the device, so the
        pool is authoritative again before any eviction gathers.  When a
        spill loss left no row to decode, no stage was attached: the
        payloads then land through an upload and the same scatter."""
        t_end = self._clock_us
        now = t_end
        for job in self._fused_jobs:
            now = max(now, self.dma.wait(job, t_end))
        if self._fused_jobs:
            self.stats.fault_exposed_us += now - t_end
            self.stats.fused_tail_us += now - t_end
            self._clock_us = now
        self.stats.fault_hidden_us = self.dma.stats["hidden_us"]
        self._fused_jobs = []
        if self._fused_staged:
            t0 = self._fused_t0
            ready = sum(1 for _sp, _pl, t in self._fused_staged if t <= t0)
            self.stats.fused_ready_pages += ready
            self.stats.fused_drained_pages += \
                len(self._fused_staged) - ready
            pps = self.cache.pages_per_shard
            gidx = [s * pps + p for (s, p), _pl, _t in self._fused_staged]
            if self._fused_stage is None:
                self._scatter_pages(gidx,
                                    [pl for _sp, pl, _t in self._fused_staged])
            else:
                self._land(self._index(gidx), *self._fused_stage)
            self._fused_staged = []
            self._fused_stage = None

    # --------------------------------------------- async prefetch pipeline

    def _drain_prefetches(self) -> None:
        """Step start: publish the transfers that completed during the
        previous decode into the staging front buffer (double-buffer
        swap)."""
        for job in self.dma.drain(self._clock_us):
            if job.direction == "out":
                continue    # outbound gathers: settled by drain, no staging
            self.prefetch.forget(job.keys)
            for key, payload in zip(job.keys, job.payloads):
                # Pre-staged keys stage under the rid before admission
                # registers the host copy: they pass on _prestage_keys.
                if (self.host.has(*key) or key in self._prestage_keys) \
                        and key[0] not in self._foreign:
                    self.staging.stage(key, payload)
                else:   # owner retired/migrated while the DMA was in flight
                    self.prefetch.stats["wasted_pages"] += 1
                    self.stats.prefetch_wasted += 1
        self.staging.swap()
        self.stats.fault_hidden_us = self.dma.stats["hidden_us"]

    def _resume_candidates(self) -> List[Request]:
        """Resume candidates in the order _admit considers them: highest
        priority first; within a tier tightest deadline slack first,
        deadline-free requests FIFO last (stable sort)."""
        return sorted(self.preempted,
                      key=lambda r: (-r.priority, self._slack_or_inf(r)))

    def _issue_prefetch(self) -> None:
        """Just before decode: issue the predicted next-step touches to the
        DMA channels so they transfer while this step computes.  The
        resume-prefetch window widens with the resume queue's deadline
        pressure (``Prefetcher.plan_depth``)."""
        resume = self._resume_candidates()
        depth = self.prefetch.plan_depth(
            [self._slack(r) for r in resume], self.slo_urgency_us)
        preds = self.prefetch.predict(
            self.cache, self.host, [r.rid for r in self.active],
            [r.rid for r in resume], depth=depth)
        by_shard: Dict[int, List[Tuple[Key, int]]] = {}
        by_seq: Dict[int, List[Key]] = {}
        for key, ppn in preds:
            if self.staging.contains(key) or key in self.prefetch.in_flight:
                continue        # already staged or on a channel
            if not self.host.has(*key):
                continue
            if ppn is not None:
                by_shard.setdefault(key[1], []).append((key, ppn))
            else:
                by_seq.setdefault(key[0], []).append(key)
        jobs = []
        for s, group in sorted(by_shard.items()):
            # Mapped targets: real ppns drive the contiguous-run cost.
            jobs.append(self.dma.enqueue(
                [k for k, _p in group], [p for _k, p in group],
                self.page_bytes, [self.host.peek(*k) for k, _p in group],
                self._clock_us, kind="prefetch"))
        for rid, keys in sorted(by_seq.items()):
            # Resume candidates have no frames yet: the transfer gathers
            # into contiguous staging slots, so it merges into one DMA.
            jobs.append(self.dma.enqueue(
                keys, list(range(len(keys))), self.page_bytes,
                [self.host.peek(*k) for k in keys],
                self._clock_us, kind="prefetch"))
        for job in jobs:
            self._account_prefetch(job)

    def _account_prefetch(self, job: DMAJob) -> None:
        """Register an issued inbound prefetch job: in-flight tracking and
        the transfer accounting (one site for the per-step predictor and
        the admission-time prefix prefetches)."""
        for key in job.keys:
            self.prefetch.in_flight[key] = job
        self.prefetch.stats["issued_pages"] += len(job.keys)
        self.stats.fault_dmas += job.dma_count
        self.stats.bytes_in += job.nbytes
        self.stats.transfer_us += job.transfer_us

    # --------------------------------------------------------- prefill

    def _match_prefix(self, req: Request):
        """Longest cached page-aligned prefix usable for this admission.

        Capped one page short of the prompt when the whole prompt is
        cached: the engine always prefills ≥ 1 real token, so the first
        output token comes from live computation.  A shared (cluster)
        index attached to a non-dense replica never matches: this engine
        could not replay the cached KV."""
        if self.prefix is None or not self.prefix_supported:
            return None
        ptok = self.geo.page_tokens
        T = len(req.prompt)
        n, pages = self.prefix.match(req.prompt)
        n = min(n, (T - 1) // ptok)
        if n <= 0:
            self.stats.prefix_misses += 1
            return None
        self.stats.prefix_hits += 1
        return pages[:n]

    def _prefill(self, req: Request):
        """Prefill an already-allocated request: suffix-only when a cached
        prefix matches, full otherwise.  Each admission records a modeled
        latency sample (admit_lat_us): tokens actually prefilled x
        prefill_us_per_token, plus the disk stall a cache hit paid to
        promote spilled prefix frames back."""
        T = len(req.prompt)
        with self._span("serve.prefill") as sp:
            match = self._match_prefix(req)
            promote_us = self._prefill_suffix(req, match) if match else None
            if promote_us is None:
                if match:
                    # The matched payloads were quarantined mid-admission:
                    # full prefill; the prefix is re-parked at completion.
                    self.stats.prefix_rederives += 1
                self._prefill_full(req)
        if promote_us is not None:
            self.stats.admit_hits += 1
            self.stats.admit_hit_us += sp.seconds * 1e6
            model_us = (T - len(match) * self.geo.page_tokens) \
                * self.prefill_us_per_token + promote_us
        else:
            self.stats.admit_colds += 1
            self.stats.admit_cold_us += sp.seconds * 1e6
            model_us = T * self.prefill_us_per_token
        self.stats.admit_lat_us.append(model_us)

    def _prefill_suffix(self, req: Request, pages) -> Optional[float]:
        """Cache-hit admission: restore the matched prefix pages through
        the host tier instead of recomputing them, and forward only the
        suffix (its queries attend over the cached KV).

        The matched pages' payloads are (1) registered in the host store
        under this request (the index's own copies stay, shared and
        unpopped), (2) their freshly-allocated pages demoted to
        non-resident, so they fault in like any host-backed page, and (3)
        in async and fused mode prefetched through the DMA pipeline now,
        at admission.  The attention needs the prefix KV now, so the
        payloads are also copied to the card once for it (counted apart,
        in ``prefix_h2d_*``: the modeled transfer is the fault-in's).

        Matched pages whose frames the shared tier spilled to disk are
        promoted before the payload reads, and the modeled disk stall is
        returned (it advances the clock and the admission latency sample).
        Returns None, before any request-visible side effect, when the
        promote quarantined a matched page: the caller falls back to full
        prefill."""
        ptok = self.geo.page_tokens
        T = len(req.prompt)
        P = len(pages) * ptok
        self._run_compaction()
        promote_us = self.host.ensure_resident(
            [(pg.owner, pg.shard, pg.vpn) for pg in pages],
            now_us=self._clock_us)
        if any(not self.host.has(pg.owner, pg.shard, pg.vpn)
               for pg in pages):
            return None
        if promote_us:
            self._clock_us += promote_us
            self.stats.promote_stall_us += promote_us
            self.stats.promotions += 1
        payloads = [self.prefix.payload(pg) for pg in pages]
        locs = [(pg.shard, pg.vpn) for pg in pages]
        for (s, vpn), (kp, vp) in zip(locs, payloads):
            self.host.put(req.rid, s, vpn, kp, vp, kind="reuse")
        entries = self.cache.demote_prefix_pages(req.rid, locs)
        self.prefix.stats["reused_tokens"] += P
        # [L, B=1, P, kv, dh] stacked prefix KV for the layer loop.
        pk = torch.stack([p[0] for p in payloads], dim=1)
        pv = torch.stack([p[1] for p in payloads], dim=1)
        L = pk.shape[0]
        pk = pk.reshape(L, 1, P, *pk.shape[3:])
        pv = pv.reshape(L, 1, P, *pv.shape[3:])
        self._sync()
        with self._span("serve.prefix_h2d", "prefix_h2d_s"):
            pk, pv = pk.to(self.device), pv.to(self.device)
            self._sync()
        self.stats.prefix_h2d_bytes += pk.nbytes + pv.nbytes
        with self._span("serve.prefill_fwd", "prefill_s"):
            Tpad = ((T + ptok - 1) // ptok) * ptok
            tokens = torch.zeros((1, Tpad - P), dtype=torch.int32)
            tokens[0, :T - P] = torch.from_numpy(
                np.asarray(req.prompt[P:], np.int32))
            ctx = self._ctx_global(self.cache.pack_ctx(
                [req.rid], self.mpps, device=self.device))
            logits, _, state = self.lm.prefill(
                {"tokens": tokens.to(self.device)}, self.pools, ctx,
                last_pos=self._index([T - 1 - P]), prefix_kv=(pk, pv),
                prefix_len=P)
            self.states[req.rid] = state
            req.out.append(int(torch.argmax(logits[0])))
        self.stats.prefill_tokens += T - P      # compute actually done
        self.stats.prefix_reused_tokens += P
        # Admission-time fault-in through the async pipeline: the first
        # decode step that touches these pages finds them in flight (or
        # already staged) instead of paying a cold demand fault.
        if self.fault_mode in ("async", "fused"):
            # Pre-staged keys whose source owner no longer matches are
            # stale (the index re-parked other bytes at the same (shard,
            # vpn) since the router's probe): cancel the rid's pre-stage
            # before the dedup pass.
            if any(self._prestage_keys.get((req.rid, s, vpn),
                                           pages[i].owner) != pages[i].owner
                   for i, (s, vpn, _ppn) in enumerate(entries)):
                self.cancel_prestage(req.rid)
            by_shard: Dict[int, List[int]] = {}
            for i, (s, vpn, _ppn) in enumerate(entries):
                key = (req.rid, s, vpn)
                if key in self._prestage_keys and (
                        self.staging.contains(key)
                        or key in self.prefetch.in_flight):
                    # Pre-staged while the request was queued: the same
                    # payload is staged or in flight under this key.
                    self._note_prestage_hit(key)
                    continue
                by_shard.setdefault(s, []).append(i)
            for s, idxs in sorted(by_shard.items()):
                job = self.dma.enqueue(
                    [(req.rid, entries[i][0], entries[i][1]) for i in idxs],
                    [entries[i][2] for i in idxs],
                    self.cache.mgrs[s].residency.page_bytes,
                    [payloads[i] for i in idxs],
                    self._clock_us, kind="prefetch")
                self._account_prefetch(job)
                self.stats.prefix_fault_us += job.transfer_us
        return promote_us

    def _park_prefix(self, req: Request) -> None:
        """Completion hook: park the finished request's full prompt pages
        in the prefix index so future admissions sharing the prefix fault
        them in instead of re-prefilling.

        Only the chain suffix the index is missing is parked (chained
        hashes dedupe shared prefixes for free).  Payloads come from the
        device pool (resident pages: one batched gather that rides the
        outbound DMA lanes) or from the request's own host copies (pages
        still swapped out); a page with neither truncates the chain,
        keeping the index prefix-closed.

        A family whose KV a suffix prefill cannot replay (a non-dense
        replica on a cluster-shared index) skips the park and counts it;
        while the host tier's write-back buffer is full the park is
        refused and counted (never caching is always token-safe)."""
        if self.prefix is None:
            return
        if not self.prefix_supported or self.pools is None:
            self.stats.prefix_park_skipped += 1
            return
        if not self.host.park_allowed():
            self.stats.prefix_park_refused += 1
            return
        hashes = self.prefix.chain_hashes(req.prompt)
        start = self.prefix.missing_from(hashes)
        if start >= len(hashes):
            return
        # Pending compaction plans rewrote tables; land the copies before
        # gathering through them (same rule as _preempt).
        self._run_compaction()
        rid = req.rid
        to_park: List[Tuple[int, int, int, Optional[Tuple]]] = []
        gather_entries: List[Tuple[int, int, int]] = []
        for gp in range(start, len(hashes)):
            s, vpn = self.cache.locate_page(gp)
            mgr = self.cache.mgrs[s]
            if rid not in mgr.tables or vpn >= len(mgr.tables[rid].ppn):
                break
            ppn = mgr.tables[rid].ppn[vpn]
            if ppn >= 0 and mgr.residency.resident[ppn]:
                gather_entries.append((s, vpn, ppn))
                to_park.append((gp, s, vpn, None))
            elif self.host.has(rid, s, vpn):
                to_park.append((gp, s, vpn, self.host.peek(rid, s, vpn)))
            else:
                break
        if not to_park:
            return
        gathered = self._gather_pages(gather_entries)
        git = iter(gathered)
        out_keys: List[Key] = []
        parent = hashes[start - 1] if start else None
        for gp, s, vpn, payload in to_park:
            from_device = payload is None
            if from_device:
                payload = next(git)
            page = self.prefix.park(hashes[gp], parent, gp, s, vpn,
                                    *payload)
            if from_device:
                out_keys.append((page.owner, s, vpn))
            parent = hashes[gp]
        self.stats.prefix_parked_pages += len(to_park)
        # The device gather is outbound traffic on the duplex channels.
        self._enqueue_outbound(out_keys, gather_entries, gathered,
                               kind="park")

    def _prefill_full(self, req: Request):
        """Cold admission: full-prompt forward for an already-allocated
        request.  The prompt is right-padded with token 0 to a page
        multiple and the recurrent families' state is taken after the
        padded prompt, as the reference does (its tokens therefore depend
        on the page size for ssm and hybrid)."""
        ptok = self.geo.page_tokens
        T = len(req.prompt)
        Tpad = ((T + ptok - 1) // ptok) * ptok
        # Allocation under memory pressure may have compacted: the tables
        # already point at the new locations, so the data copies must land
        # before the device reads them (and before the pages freed by
        # compaction are overwritten by this prefill).
        self._run_compaction()
        with self._span("serve.prefill_fwd", "prefill_s"):
            ctx = self._ctx_global(self.cache.pack_ctx(
                [req.rid], self.mpps, device=self.device))
            tokens = torch.zeros((1, Tpad), dtype=torch.int32)
            tokens[0, :T] = torch.from_numpy(
                np.asarray(req.prompt, np.int32))
            batch = {"tokens": tokens.to(self.device)}
            # The frontends are stubs, as in the reference: zero image
            # patches (vlm) and zero source frames (encdec).
            dtype = getattr(torch, self.cfg.dtype)
            if self.cfg.family == "vlm":
                batch["patch_embeds"] = torch.zeros(
                    (1, self.cfg.frontend_tokens, self.cfg.d_model),
                    dtype=dtype, device=self.device)
            if self.cfg.family == "encdec":
                batch["src_embeds"] = torch.zeros(
                    (1, self.cfg.encdec.source_len, self.cfg.d_model),
                    dtype=dtype, device=self.device)
            logits, _, state = self.lm.prefill(
                batch, self.pools, ctx, last_pos=self._index([T - 1]))
            self.states[req.rid] = state
            req.out.append(int(torch.argmax(logits[0])))
        # Tokens beyond T within the padded page are unused; the tracked
        # length stays T (+1 for the decode append).
        self.stats.prefill_tokens += T

    def _ctx_global(self, ctx: PageCtx) -> PageCtx:
        """Convert per-shard local page ids to global pool ids (global id =
        shard * pages_per_shard + local id)."""
        if self.cache.S == 1:
            return ctx
        pps = self.cache.pages_per_shard
        off = torch.arange(self.cache.S, dtype=torch.int32,
                           device=ctx.tables.device) * pps
        tables = torch.where(ctx.tables >= 0, ctx.tables + off[None, :, None],
                             -1)
        wpage = torch.where(ctx.wpage >= 0, ctx.wpage + off[None, :], -1)
        return dataclasses.replace(ctx, tables=tables, wpage=wpage)

    # ------------------------------------------------------------- stepping

    def _append_with_preemption(self) -> List[Request]:
        """Grow active requests by one token slot, highest priority first.

        Under pool pressure a request may displace peers of its own tier or
        below; with no displaceable victim it stalls this step.  If nobody
        can grow, the lowest-priority request is swapped out so the rest
        make progress next step.  Returns this step's decode batch.
        """
        order = sorted(self.active, key=lambda r: -r.priority)  # stable
        appended: List[Request] = []
        for r in order:
            if r not in self.active:
                continue            # preempted as someone else's victim
            while r in self.active:
                try:
                    self.cache.append(r.rid, 1)
                    appended.append(r)
                    break
                except OutOfMemory:
                    victim = self._pick_victim(
                        below_priority=r.priority + 1,
                        exclude=tuple(a.rid for a in appended) + (r.rid,))
                    if victim is None:
                        break       # stall: retry next step
                    self._preempt(victim)
        if not appended and self.active:
            victim = self._pick_victim()
            if victim is not None and len(self.active) > 1:
                self._preempt(victim)
        return [r for r in self.active if r in appended]

    def step(self) -> bool:
        """One engine iteration: (async/fused: drain completed prefetches)
        → admit → grow → compact → fault in → decode (async/fused: while
        the next step's prefetches are in flight) → (fused: settle) →
        retire.  Each phase runs in its span and every call leaves one
        record in the step log (:mod:`repro_torch.serving.spans`)."""
        with spans.step_record(self.engine_id, self.cache):
            if not self.alive:
                return False        # a crashed engine does no work
            with self._span("serve.step", "wall_s"):
                return self._step()

    def _step(self) -> bool:
        with self._span("serve.host_tier"):
            # Advance the host tier's write-back pipeline to the engine
            # clock: frames whose spill completed persist now, before this
            # step's admissions and parks consult park_allowed().
            self.host.pump(self._clock_us)
            if self.fault_mode in ("async", "fused"):
                # Publish transfers that finished during the last decode so
                # admission's resumes and this step's fault-in see them.
                self._drain_prefetches()
        with self._span("serve.admit"):
            self._admit()
        if not self.active:
            return False
        with self._span("serve.grow"):
            runnable = self._append_with_preemption()
        if not runnable:
            # A permanent stall means some request can never grow: fail
            # loudly rather than spinning to the step cap.
            self._stalled_steps += 1
            if self._stalled_steps > 64:
                raise OutOfMemory(
                    f"engine stalled {self._stalled_steps} consecutive "
                    f"steps: active requests "
                    f"{sorted(r.rid for r in self.active)} cannot grow "
                    f"(pool too small or fragmentation unrecoverable)")
            return bool(self.active or self.queue or self.preempted)
        self._stalled_steps = 0
        seqs = [r.rid for r in runnable]
        # Appends under pressure may compact: execute the copy plan before
        # decode consumes the updated tables.
        self._run_compaction()
        with self._span("serve.fault_in"):
            lost = self._fault_in(seqs)
        if lost:
            # A spill quarantine destroyed some batch members' payloads
            # mid-promote: restart them from the prompt, decode the rest.
            self._restart_lost(lost)
            runnable = [r for r in runnable if r.rid not in lost]
            seqs = [r.rid for r in runnable]
            if not runnable:
                if self.fault_mode == "fused":
                    # No decode window opens: settle the collected jobs
                    # and land the staged payloads now.
                    with self._span("serve.settle"):
                        self._settle_fused()
                return bool(self.active or self.queue or self.preempted)
        with self._span("serve.pack"):
            ctx = self._ctx_global(self.cache.pack_ctx(seqs, self.mpps,
                                                       device=self.device))
            if self.fault_mode == "fused":
                # Decode on what is resident plus this step's staged
                # arrivals.
                ctx = self._attach_staging(ctx)
        if self.fault_mode in ("async", "fused"):
            # Predicted next-step touches ride the channels during decode.
            with self._span("serve.prefetch"):
                self._issue_prefetch()
        with self._span("serve.decode", "decode_s") as dec:
            toks = self._index([r.out[-1] for r in runnable])
            pos = self._index([self.cache.seq_tokens[r.rid] - 1
                               for r in runnable])
            state = self._stack_states(seqs)
            logits, _, state = self.lm.decode_step(toks, pos, self.pools,
                                                   ctx, state)
            nxt = logits.argmax(dim=-1).cpu().tolist()
        # The decode step is the window in-flight transfers hide in: the
        # modeled width if configured, else the measured time.
        self._clock_us += (self.decode_window_us
                           if self.decode_window_us is not None
                           else dec.seconds * 1e6)
        if self.fault_mode == "fused":
            # Settle the consumed jobs (only tails past the window are
            # exposed) and scatter the staged pages before any eviction.
            with self._span("serve.settle"):
                self._settle_fused()
        # The decode window may have carried queued write-backs past their
        # disk-ready time: persist them before the completion parks below.
        with self._span("serve.host_tier"):
            self.host.pump(self._clock_us)
        with self._span("serve.retire"):
            self._retire(runnable, seqs, nxt, state)
        self._run_compaction()
        with self._span("serve.pool_stats"):
            st = self.cache.stats()
        spans.count("coalesced_fraction", st.get("coalesced_fraction", 0.0))
        self.stats.coalesced_sum += st.get("coalesced_fraction", 0.0)
        self.stats.decode_steps += 1
        return True

    def _retire(self, runnable: List[Request], seqs: List[int],
                nxt: List[int], state: Dict[str, torch.Tensor]) -> None:
        """After decode: the translation meter, the batch's states split
        back, each row's token appended, and finished requests parked in
        the prefix cache and freed."""
        self._meter_translation(runnable)
        self._unstack_states(seqs, state)
        done_now = []
        for i, r in enumerate(runnable):
            r.out.append(int(nxt[i]))
            self.stats.decode_tokens += 1
            if len(r.out) >= r.max_new \
                    or self.cache.seq_tokens[r.rid] >= self.max_seq - 1:
                r.done = True
                done_now.append(r)
                if r.deadline_us is not None:
                    self.stats.note_deadline(
                        r.priority, self._clock_us <= r.deadline_us)
        for r in done_now:
            # Park the finished prompt's pages in the prefix cache before
            # the pages are freed and the host copies dropped.
            with self._span("serve.park"):
                self._park_prefix(r)
            if self.translation_meter is not None:
                # The address space retires with the sequence.
                for s in range(self.cache.S):
                    self.translation_meter.drop_space((r.rid, s))
            self.active.remove(r)
            self.cache.free(r.rid)
            self.states.pop(r.rid, None)
            self.host.drop_seq(r.rid)
            self._note_prestage_waste(r.rid)
            dropped = self.staging.invalidate_seq(r.rid)
            self.stats.prefetch_wasted += dropped
            self.prefetch.stats["wasted_pages"] += dropped
            self.prefetch.cancel_seq(r.rid)
            self._saved_tokens.pop(r.rid, None)

    def _meter_translation(self, runnable: List[Request]) -> None:
        """Run this step's KV page tables through the translation meter.
        Each (seq, shard) pair is an address space; latency is charged to
        the request's tenant.  Observational: decode and the engine clock
        are untouched."""
        if self.translation_meter is None:
            return
        tables = []
        for r in runnable:
            for s, m in enumerate(self.cache.mgrs):
                t = m.tables.get(r.rid)
                if t is not None:
                    tables.append(((r.rid, s), r.tenant, t.ppn))
        d = self.translation_meter.step_access(self._clock_us, tables)
        st = self.stats
        st.translation_lookups += int(d["lookups"])
        st.translation_tlb_hits += int(d["tlb_hits"])
        st.translation_walks += int(d["walks"])
        st.translation_walk_cycles += d["walk_cycles"]
        st.translation_queue_cycles += d["queue_cycles"]
        st.translation_us += self.translation_meter.cycles_us(
            d["latency_cycles"])

    def translation_backlog_us(self) -> float:
        """Booked walker time beyond the engine clock, in modeled µs: the
        translation-interference term of the router's dispatch cost.  0.0
        when the meter is off."""
        if self.translation_meter is None:
            return 0.0
        return self.translation_meter.backlog_us(self._clock_us)

    def _run_compaction(self):
        """Execute pending CAC copy plans on the device (one kernel launch
        per pool over all layers).  With the translation meter on, the
        remapped pages' subregions are splintered out of its TLB."""
        with self._span("serve.compact"):
            ops = self.cache.drain_copy_ops()
            if ops and self.translation_meter is not None:
                for s, op in ops:
                    owner_vpn = self.cache.mgrs[s].rmap.get(op.dst_ppn)
                    if owner_vpn is not None:
                        self.translation_meter.splinter(
                            (owner_vpn[0], s), owner_vpn[1])
            if not ops or self.pools is None:
                return
            pps = self.cache.pages_per_shard
            src = self._index([s * pps + op.src_ppn for s, op in ops])
            dst = self._index([s * pps + op.dst_ppn for s, op in ops])
            k, v = self.pools
            kops.page_compact(k, src, dst)
            kops.page_compact(v, src, dst)
            self.stats.compaction_copies += len(ops)

    # ------------------------------------------------------------- states

    def _stack_states(self, seqs: List[int]) -> Dict[str, torch.Tensor]:
        """The decode batch's state: each request's {"ssm", "conv"} or
        {"cross_k", "cross_v"} concatenated along the batch axis (axis 1
        of [L, B, ...]); empty for the other families."""
        if not self.states:
            return {}
        keys = self.states[seqs[0]].keys()
        return {k: torch.cat([self.states[s][k] for s in seqs], dim=1)
                for k in keys}

    def _unstack_states(self, seqs: List[int],
                        stacked: Dict[str, torch.Tensor]) -> None:
        for k, v in stacked.items():
            for s, part in zip(seqs, torch.split(v, 1, dim=1)):
                self.states[s][k] = part

    # ------------------------------------------------------------- run

    def run_until_drained(self, max_steps: int = 10_000) -> int:
        steps = 0
        while (self.queue or self.active or self.preempted) \
                and steps < max_steps:
            self.step()
            steps += 1
        if self.fault_mode in ("async", "fused") and not (
                self.queue or self.active or self.preempted):
            # Settle transfers still on the channels so the hidden/exposed/
            # wasted split covers every issued byte.
            self._clock_us = max(self._clock_us, self.dma.busy_until())
            self._drain_prefetches()
        self.host.pump(self._clock_us)
        return steps
