#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each synchronised; any failure exits non-zero):

1. environment: the card's name and power limit, torch version; TF32 off;
2. build: every ``csrc/*.cu`` with nvcc for sm_90a, one nvcc per source;
3. kernel checks at the serving path's shapes: each CUDA kernel against its
   plain PyTorch version on the card (paged attention, both granularities,
   with holes and partial pages; fused gather-attend with about half the
   pages staged, and bit for bit against the page kernel where it reads
   the same bytes; gather / scatter / compact exactly; prefill flash
   attention on a full 1152-token prompt and on its suffix from position
   576, whose rows must equal the full call's bit for bit; the SSD scan at
   zamba2-1.2b's prefill shape with its one B/C group, the main path's
   call, and head-expanded, at mamba2-1.3b's, and with a carried initial
   state over 192-row chunks), and their times (CUDA-graph replay for kernels and library calls, CUDA events for
   the plain versions) beside their bound: bytes at 3.35 TB/s or bf16
   operations at 989 TFLOP/s, whichever is larger.  Paged attention is
   also timed at B = 1, and flash and paged attention at zamba2-1.2b's
   shared-block shapes (H = n_kv = 32, dh = 64: one query head per KV
   head) and dbrx-132b's (H = 48 over n_kv = 8, dh = 128: six query heads
   per KV head), with the page copies at their page sizes; each [kernel]
   line names the split count or tile shape.  At
   deepseek-v2-lite's MLA shapes (entries ``<kernel>.mla`` of the kernels
   line): paged attention over latent pools (16 query heads on one KV
   head, K 576 / V 512, page and frame, B = 4 and 1) and flash attention
   at dh 192 / dh_v 128 (full prompt and its suffix, bitwise), and the
   page copies on the latent pools.  At the shapes of phases 4g-4i
   (entries ``<kernel>.<tag>``): flash attention, each also timed beside
   ``scaled_dot_product_attention`` and with queries at 3x unit scale so
   that outputs are O(1), non-causal for seamless-m4t's encoder over 4096
   frames (``.encoder``), its cross-attention of a 1152-row prompt over
   them (``.cross_prefill``) and of one row per sequence at B = 4, cycling
   its 24 layers' cross K/V (``.cross_decode``), causal for llava's 2880
   image + 1152 prompt rows (``.vlm``) and phi3's 1152-token prompt at
   head dim 96 (``.phi3``); paged attention at g = 4 / dh 128
   (``.g4d128``, page and frame) and g = 1 / dh 96 (``.g1d96``), its o / l
   at the f32 tolerance; fused gather-attend at llava's g = 4 / dh 128
   (``.g4d128``) and seamless's g = 1 / dh 64 (``.g1d64``), each also bit
   for bit the page kernel on the same bytes; the page copies at phi3's
   393,216-byte page;
4. main path: qwen2.5-3b at its published width, bf16, random weights from
   a seed, served by ``ServingEngine`` (mosaic, 2x oversubscribed) over a
   seeded stream with staggered priority arrivals, three times on the same
   weights: sync, async and fused fault-in (async and fused leave
   ``decode_window_us`` unset, so their modeled clock follows the measured
   decode time), each with the prefix cache on (the default; the stream
   shares no prefix, so admissions miss and completions park).  During
   each run one dual-granularity attention call reads the engine's pool
   through ``pack_dual`` frame tables, and a partial deallocation of one
   request's pages makes CAC plan copies that the engine executes.  Launch
   counters are reset before and read after each run: every kernel of that
   mode's path must have launched, the counts must account for every
   prefill layer, decode layer, landing, eviction, park and fused step, and
   the three modes must emit identical tokens;
4b. prefix cache at full width, same weights.  First a probe, printed and
   not checked: whether 64 rows of a bf16 product over the FFN's inputs
   get the same bits alone as inside a 576-row product (the reason prefill
   runs on fixed row blocks).  Then six requests over three
   tenants share a 512-token system prompt, two arrive first and four
   after those drain; served in sync, async and fused with the cache on and
   in async with it off.  The four runs must emit identical tokens, the
   cache must hit at least four times and cut prefill tokens by exactly
   the reused tokens, and each run's launches must account for every
   prefill layer (full or suffix) as above;
4c. hybrid main path: zamba2-1.2b at its published width (38 Mamba-2
   layers, one shared attention block invoked 6 times, bf16, random
   weights from a seed), same pool geometry and stream, sync, async and
   fused.  Tokens identical across the modes; at least one swap and one
   fault; launches account for 38 SSD scans and 6 flash attentions per
   admission, 6 paged (or fused) attentions per decode step, and every
   gather and landing;
4d. ssm path: mamba2-1.3b at its published width (48 layers, d_state 128,
   no KV pool), the stream's first four requests, sync and async: tokens
   identical, 48 SSD scans per admission, no attention or page launch;
5. agreement on a small input: a narrow model served on the card (kernels)
   and on the CPU (plain versions), in fused mode, emits the same greedy
   tokens;
6. application transparency: the stream without oversubscription under
   mosaic and gpu-mmu — same batches, identical tokens;
7. paging round trip: a held preemption's host payloads come back into the
   pool bit for bit;
8. the cluster tier at full width (after 7, once phase 4's copy of
   qwen2.5-3b's weights has left the card): ``ServingCluster`` of two
   ``ServingEngine`` replicas sharing one LM (weights drawn anew from seed
   0: the same weights, one copy on the card, which the memory
   high-water mark must show), phase 4's pool per engine, async fault-in,
   a shared host tier bounded at ``CLUSTER_FRAMES`` frames over a spill
   directory, the shared prefix index, work-stealing migration,
   pre-staging, the radix translation meter and ``decode_window_us`` set
   (the router's costs, and so the schedule, come from the modeled
   clock).  Traffic: phase 4b's waves (the first pinned to engine 0, the
   second routed), then phase 4's stream pinned to engine 0, whose
   priority arrivals make it preempt while engine 1 has room.
   8a: served twice; the two runs give identical tokens, router
   decisions, frame-table, tier, spill and translation counters; both
   engines dispatched; at least one migration with a whole-frame owner
   flip and every migrated request's pages in the destination pool bit
   for bit the payloads the source gathered; one admission (one flash
   launch per layer) per request: a migration re-prefills nothing;
   engine 1 hits the prefix engine 0 parked, landed by page_scatter;
   frames spilled and promoted back; ``check_invariants()`` after every
   router step; lookups on both engines.  Router-step and engine-step ms
   (host clock), promote time (host clock and modeled) and the memory
   high-water mark are printed.
   8b: a seeded ``FaultPlan``: engine 1 dies ``CRASH_AFTER`` router steps
   into the stream, disk reads fail transiently (the tier retries), and
   the first request frame written to disk is corrupted: every request
   completes, the dead engine holds no host frame after the crash (its
   preempted request re-leased whole to the survivor) while the prefix
   frames survive, at least one retry, one quarantine and one
   lost-payload restart, invariants after every step.
   8c: phase 4's stream on one engine in sync without oversubscription,
   the translation meter off, flat and radix, and radix under gpu-mmu:
   the same batches and tokens, equal lookups for flat and radix, radix
   walks <= flat walks; mosaic's and gpu-mmu's walks printed.
   8d: 8a and 8b with the narrow f32 model of phase 5 on the card and on
   the CPU: identical tokens, router decisions, tier counters and
   injector log.
4e. (after 8) deepseek-v2-lite
   at its published width cut to 2 layers (the dense one and one MoE
   layer) on the card against the same weights on the CPU (plain
   versions, the card's expert choices replayed): logits and latent pools
   of a prefill and two decode steps within 2e-2 of their scale; then at
   its published width and depth (27 layers, MLA over latent pools,
   one dense-FFN layer then 64 routed experts top-6 + 2 shared, bf16,
   ~15.7 G parameters from a seed) through phase 4's stream and step hook
   in sync and async: fused is refused (as the reference), tokens
   identical, at least one swap, fault and CAC copy, 27 flash calls per
   admission and 27 paged calls per decode step, no prefix cache;
4f. dbrx-132b at its published widths, depth-cut to its first 8 of 40
   layers (~52 GB of bf16; all 40 would not fit the card), the stream's
   first four requests in sync: 8 flash calls per admission, 8 paged calls
   per step, and the card's memory high-water mark;
4g. llava-next-mistral-7b at its published width and depth (32 layers,
   32 heads over 8 KV heads of 128, 2880 image tokens from the engine's
   zero stub in front of each prompt, bf16, ~7.3 G parameters from a
   seed) through phase 4's stream and step hook at max_seq 4096, in sync,
   async and fused: tokens identical, at least one swap, fault and CAC
   copy, request 0 holding its 2880 image tokens and its prompt, 32 flash
   calls per admission (over 2880 + the padded prompt's rows) and 32
   paged (or fused) per step, no prefix cache; then cut to 2 layers on
   the card against the CPU (in float32) with random image embeddings;
4h. seamless-m4t-large-v2 at its published width and depth (24 encoder +
   24 decoder layers, 16 heads of 64, source_len 4096 zero frames from the
   stub, vocab 256206, bf16) through the same stream and hook in sync,
   async and fused: tokens identical, at least one swap and fault, 72
   flash calls per admission (24 encoder, 24 self-, 24 cross-attention)
   and per step 24 paged (or fused) and 24 cross-attention flash calls,
   the encoder's and the cross-attention's as the wrapper counts them by
   call site;
   then cut to 2 + 2 layers on the card against the CPU with random
   source frames (logits, pools and cross K/V);
4i. llama3-8b, phi3-mini-3.8b and qwen3-8b at their published widths and
   depths, one after another, the stream's first four requests in sync,
   launches accounted for per layer; qwen3-8b (qk-norm) also cut to 2
   layers on the card against the CPU.
9. training (after every serving phase, with their weights gone):
   9a. first the optimizer-step kernels (``phase_optim_kernels``): how the
   card's eager chain divides a CUDA tensor by a CPU scalar (it must be
   x * (1.0f / c), the form both kernels reproduce); the fused AdamW
   update (``adamw``) and the error-feedback quantiser of
   ``grad_compress`` (``grad_quant``), each bit for bit its plain version
   on the card at odd sizes (one 256-element block, 257 x 256, an empty
   leaf, AdamW's vector tail and bf16 p and g, the quantiser's all-zero
   block, outlier, NaN and the quantise mode) and at qwen2.5-3b's
   14 full-width leaves, timed there beside 28 / 16 bytes an element and
   (AdamW) ``torch._fused_adamw_`` over the same lists; then
   the training kernels at qwen2.5-3b's training shape (B = 2, T =
   2048, 16 heads over 2 KV heads of 128, causal, bf16, queries at PEAK_Q
   times the unit scale): the flash forward with each row's log-sum-exp
   (``flash_attention.train``) against its plain version, its ``o`` bit for
   bit the serving call's; the hand-written backward
   (``flash_attention_bwd``) against its plain version at 2e-2 of each
   gradient's scale, and two backward calls bit for bit; an f32 case at
   the narrow model's shape (head dim 32, T = NARROW_T) at 2e-5; a
   non-causal bf16 case with Tq = 300 != Tk = 700.  Times beside the
   operations bound (the backward's five products, the forward's two, at
   989 TFLOP/s) and beside ``scaled_dot_product_attention`` (forward;
   for the backward's entry forward and backward through autograd, and,
   as ``library_bwd_ms``, its backward alone over one fixed forward);
   9b. full-width training: qwen2.5-3b at its published width and depth,
   fp32 master weights from a seed, ``Trainer`` with TrainHParams(lr=3e-4,
   warmup_steps=2, total_steps=6, remat="block"), TRAIN_B x TRAIN_T tokens
   a step (``SyntheticLM``), TRAIN_STEPS steps: every loss and grad norm
   finite, per layer and step two training forwards (remat recomputes)
   and one backward, no serving kernel; per step the loss, grad norm, step
   ms and tokens/s, then the peak memory.  The loss falls: the final
   weights' loss on the last step's batch is below that batch's loss
   before its update and below the first step's loss.  (Each logged loss
   is taken before its step's update on a fresh batch; at this learning
   rate six of them move less than the batches differ, so they are
   printed, not compared.)  The same six steps with f32 compute (the
   CUDA-core kernels, f32 products) from the same weights and data give
   every step's loss within 1e-3 relative;
   9c. in a subprocess with ``torch.use_deterministic_algorithms(True)``
   (CUBLAS_WORKSPACE_CONFIG set before CUDA starts): the narrow f32 model
   trained 4 steps on the card and on the CPU from the same weights, every
   step's loss within 1e-4 relative; then on the card a run checkpointed at
   step 2 and resumed in a fresh Trainer for 2 more steps, whose
   parameters and Adam moments equal the uninterrupted run's bit for bit;
   the same resume with the narrow deepseek-v2-lite (MLA at dh 192 / dh_v
   128 on the CUDA-core kernels, 64 experts: the MoE dispatch and combine
   under the deterministic algorithms);
   9a, continued (before 9b): the hand-written SSD-scan backward (bf16
   on the tensor cores, f32 on CUDA cores) at
   mamba2-1.3b's and zamba2-1.2b's training shapes (B 2, T 2048, 64 heads
   of 64, N 128 / 64, one B/C group, Q 256, bf16; entries
   ``ssd_scan_bwd`` and ``ssd_scan_bwd.hybrid``) against its plain
   version at SSD_BWD_TOL of each gradient's scale, and in f32 over three
   chunks of the narrow shape with an initial state and the final state's
   gradient at 2e-5; two calls bit for bit; the scan's training forward
   at the same two shapes (``ssd_scan.train``, ``ssd_scan.train.hybrid``);
   each timed beside its bound (library: none).  The flash forward with
   lse and the backward at FLASH_BWD_SHAPES (llava's self-attention over
   2880 + 1216 rows, seamless's encoder over 4096 frames, its
   cross-attention of 1024 rows over them and its decoder's causal
   self-attention, zamba2's shared block), each timed beside its bound
   and SDPA's (entries ``flash_attention.train.<tag>`` and
   ``flash_attention_bwd.<tag>``); and at the moe family's shapes
   (MOE_FLASH_SHAPES): deepseek-v2-lite's MLA attention (B 2, T 2048, H =
   n_kv = 16, dh 192 / dh_v 128, causal, bf16; ``.mla``, launches from
   9i) and dbrx-132b's (H 48 over n_kv 8, dh 128: g = 6, the dK / dV
   cluster's 4 ranks take 1, 2, 1, 2 heads; ``.moe``, 0 launches: no
   dbrx training fits the card, ZERO_LAUNCHES), and (192, 128) in f32 on
   the CUDA-core path at the narrow T, at 2e-5;
   9d. seamless-m4t-large-v2 at its published width and depth (24 + 24
   layers), fp32 master weights from seed 0, ``make_train_step`` (remat
   block) on ENCDEC_TRAIN_B x ENCDEC_TRAIN_T target tokens over ENCDEC_SRC
   random source frames a step, FAMILY_STEPS steps;
   9e. llava-next-mistral-7b at its published widths, **reduced: depth 32
   -> VLM_TRAIN_LAYERS layers** (all 32 need 115.9 GB of training state),
   B 1 x (VLM_TRAIN_P random image embeddings + VLM_TRAIN_T tokens), the
   same steps;
   9f. mamba2-1.3b at its published width and depth, ``Trainer`` on
   ``SyntheticLM``, TRAIN_B x TRAIN_T, remat block;
   9g. zamba2-1.2b likewise, remat block, which its stack ignores as the
   reference's does;
   each of 9d-9g: finite losses and grad norms, the launches of every
   layer and step (``train_launches``: flash forward with lse, flash
   backward, both also by site, SSD scan and SSD backward) and no serving
   kernel, the final
   weights' loss on the last step's batch below that batch's loss before
   its update, step ms, tokens/s and the memory high-water mark;
   9h. each family's narrow f32 model (``narrow_train_config``) trained
   FAMILY_STEPS steps on the card and on the CPU from the same weights:
   every step's loss within 1e-4 relative; the moe family's deepseek-v2-lite
   and dbrx-132b too, their CPU runs taking the card's expert choices
   (``ExpertChoices``), at least 90 % of the tokens routed alike;
   9i. deepseek-v2-lite at its published widths, **reduced: depth 27 ->
   MOE_TRAIN_LAYERS layers** (the dense one and 4 MoE; all 27 need ~283
   GB of training state), ``Trainer`` on ``SyntheticLM`` at TRAIN_B x
   TRAIN_T from seed 0, remat block, FAMILY_STEPS steps: 9d-9g's checks
   (launches: two flash forwards with lse and one backward at dh 192 /
   dh_v 128 per layer and step) and the MoE aux loss finite and above 0;
   9j. data-parallel training through the distributed code, in ranks that
   ``launch/spawn.py`` starts (a FileStore rendezvous in a temporary
   directory): full-width qwen2.5-3b on a one-rank NCCL group, megatron +
   ZeRO-1 + ``grad_compress``, TRAIN_B x TRAIN_T, remat block, DIST_STEPS
   steps (step ms, tokens/s, peak GiB; the last step's batch scores lower
   after its update); the narrow f32 model under megatron +
   ``grad_compress`` and under fsdp on the card's rank and on a gloo CPU
   rank (losses within 1e-4); the card rank's step-2 checkpoint resumed
   on 2 gloo CPU ranks (the restored state bit for bit the saved arrays,
   each rank holding half the f32 master elements of every leaf that
   ``zero1_specs`` splits over data, both counts printed, the next losses
   within 1e-4 of the CPU rank's).  The card rank's AdamW and
   quantiser launches (one each per leaf and step in (a)) count under
   ``adamw`` and ``grad_quant``;
   9k. tensor and expert parallelism over a ``model`` axis of 2, in gloo
   ranks sharing cuda:0 (NCCL cannot put two ranks on one GPU; their step
   times are two ranks time-sharing the card, not a TP speed): (a)
   qwen2.5-3b at its published widths, **reduced: depth 36 -> TP_LAYERS
   layers** (two ranks' training state on one card), megatron, remat
   "save_collectives", TRAIN_B x TRAIN_T, TP_STEPS steps, on one rank (in
   this process) and at TP_MESH: step ms, tokens/s, peak GiB per rank; 4
   all-reduces over ``model`` a layer and step by kind and none for the
   gathered leaves; step 1's loss within 5e-3 of the one-rank run's; the
   last step's batch scores lower after its update; the flash kernels'
   launches at the shard's shape (phase 9a's ``.tp`` entries, timed at
   TP_FLASH_SHAPE: 8 query heads over 1 KV head); (b) qwen2.5-3b,
   qwen3-8b, dbrx-132b and deepseek-v2-lite as f32 models the card's
   kernels take (``narrow_tp_config``: EP at 4 experts, 2 a rank; MLA
   gathered) at TP_MESH on the card's ranks and on gloo CPU ranks (the
   MoE models' CPU runs replaying the card's expert choices): losses
   within 1e-4; (c) (b)'s qwen2.5-3b step-2 checkpoint resumed on 2 gloo
   CPU ranks at (2, 1): the restored state bit for bit the saved arrays.
10. serving over a mesh (``phase_serve_mesh``), in gloo ranks sharing
   cuda:0 (every time printed is ranks time-sharing the card): (a)
   qwen2.5-3b at its published width and depth, bf16, at SERVE_MESH (1, 2):
   four 3000-4000-token prompts (every row's frames on both page ranks),
   prefill and SERVE_STEPS decode steps fed the one-rank run's greedy
   tokens, against that run in this process: logits within
   MESH_LOGITS_TOL of their scale, one flash launch per layer at prefill
   and one paged launch per layer and step on every rank, prefill and step
   ms, peak GiB per rank; (b) deepseek-v2-lite at its published widths and
   depth at MOE_SERVE_MESH (2, 2), the batch split over ``data``: the 2-D
   EP (its decode's gather and dense-masked pass, its prefill's expert
   gathers over ``data``) and MLA's decode over striped latent pools, as
   (a); (c) the narrow f32 models of qwen2.5-3b, deepseek-v2-lite (its
   prefill and latent pools: the MLA paged kernel takes bf16) and dbrx-132b
   at (1, 2) and (2, 2) on the card's ranks and on gloo CPU ranks: logits
   within 1e-4; (d) the dry run's lines for qwen2.5-3b train_4k and
   decode_32k on the production 16 x 16 mesh.  Phase 3's
   ``phase_mesh_kernels`` times the paged kernel over rank 0's stripe of
   (a) and (b) and the flash kernel at (a)'s shard (8 query heads over 1
   KV head).

11. the port's examples as a user runs them (``phase_examples``):
   ``torch_quickstart.py`` and ``torch_long_context.py --ctx 4096``
   (invariants, mosaic's 0-copy coalescing, page-granular faults moving
   fewer bytes than frame-granular ones); ``torch_serve_multitenant.py
   --device cuda`` on README's command lines and the plain ``--requests
   12``, the paging line with ``--translation radix``, one after the
   other in one process
   (``EXAMPLE_SERVE``; outputs identical across managers; wall seconds
   and tok/s); and ``torch_train_lm.py --device cuda`` at its demo-100m
   default: 80 steps, then, in a process of its own, 80 steps resumed from
   that run's step-50 checkpoint, whose losses after step 50 must be the
   first run's bit for bit (step ms and tokens/s printed).  Then
   ``phase_example_kernels`` holds every kernel the examples launched
   against its plain version at the examples' shapes: the serving
   example's (head dim 16, 512-byte pages; ``.smoke`` entries) and the
   training example's (demo-100m's attention, 8 query heads over 4 KV
   heads of 64; ``.example`` entries).

Ends with the script's total time, a JSON line of per-kernel numbers and,
last, the ok line.  Launches of an entry: those of its kernel at the
entry's shapes in the serving runs (``family_entries``): ``.mla`` from
phase 4e, ``.vlm`` and ``.g4d128`` from 4g and 4i, ``.phi3`` and
``.g1d96`` from phi3's run, ``.g1d64`` and the flash kernel's counts by
call site (``.encoder`` / ``.cross_prefill`` / ``.cross_decode``) from
4h; every other launch of phases 4, 4c, 4d, 4f-4i and 8a-8c under its
kernel's own entry; ``flash_attention.train`` and ``flash_attention_bwd``
from phase 9b; ``adamw`` from phases 9b, 9d-9g, 9i and 9j (every leaf's
update), ``grad_quant`` from 9j; the entries of phases 9d-9g from the
phase of their shape, seamless's three attentions by the site its
wrappers counted
(``train_entries``); the training ``.mla`` entries from phase 9i, the
``.moe`` entries none (``ZERO_LAUNCHES`` says why), the ``.tp`` entries
from phase 9k (a)'s two ranks, the ``.mesh`` entries from phase 10's
ranks ((a)'s flash and paged launches, (b)'s paged), the ``.smoke``
entries from phase 11's serving runs (a kernel they did not launch has
none) and the ``.example`` entries from its two training runs.  Of the
serving phases only 4f is cut in depth; of the training phases 9e, 9i and
9k (a).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "qwen2.5-3b"
HYBRID_ARCH, SSM_ARCH = "zamba2-1.2b", "mamba2-1.3b"
MLA_ARCH, MOE_ARCH = "deepseek-v2-lite-16b", "dbrx-132b"
VLM_ARCH, ENCDEC_ARCH = "llava-next-mistral-7b", "seamless-m4t-large-v2"
DENSE_ARCHS = ("llama3-8b", "phi3-mini-3.8b", "qwen3-8b")   # phase 4i
DENSE_REQUESTS = 4      # phase 4i serves the stream's first four requests
VLM_MAX_SEQ = 4096      # 2880 image tokens + a 1100-token prompt + decode
SSM_REQUESTS = 4        # phase 4d serves the stream's first four requests
MOE_REQUESTS = 4        # and phase 4f too
MOE_LAYERS = 8          # phase 4f: dbrx's first 8 of 40 layers (52 GB)
MAX_BATCH, MAX_SEQ, OVERSUB = 4, 2048, 2.0
ARRIVE_STEP = 10        # the two priority-1 requests arrive here
PROBE_STEP = 3          # dual-granularity attention over the engine's pool
TRIM_STEP = 6           # partial deallocation of request 0's pages
TRIM_VPNS = range(2, 14)
FLASH_T, FLASH_P = 1152, 576   # phase 3: full prompt, cached prefix length
PREFIX_TOKENS, PREFIX_NEW = 512, 16      # phase 4b: system prompt, max_new
CLUSTER_ENGINES = 2     # phase 8: replicas sharing one LM on the card
CLUSTER_FRAMES = 2      # host DRAM bound: 2 frames of 16 pages (~75 MB)
CLUSTER_WINDOW_US = 50_000.0   # modeled decode window, about the step
CLUSTER_RID = 100       # the stream's rids follow the waves' 0-5
CRASH_AFTER = 12        # phase 8b: engine 1's crash, in steps into the stream
READ_ERROR_RATE = 0.5   # phase 8b: transient disk-read errors per read
TRAIN_B, TRAIN_T = 2, 2048     # phase 9: qwen2.5-3b's --batch 2 --seq 2048
TRAIN_STEPS = 6
NARROW_T = 256          # phase 9a/9c/9h: the narrow model's training length
FAMILY_STEPS = 3        # phases 9d-9h: steps of each family's training
ENCDEC_TRAIN_B, ENCDEC_TRAIN_T = 2, 1024   # phase 9d: target tokens a row,
ENCDEC_SRC = 4096       # over seamless's 4096 source frames
VLM_TRAIN_LAYERS = 8    # phase 9e: llava's first 8 of 32 layers (32.1 GB of
VLM_TRAIN_P, VLM_TRAIN_T = 2880, 1216      # training state): image + text
MOE_TRAIN_LAYERS = 5    # phase 9i: deepseek-v2-lite's first 5 of 27 layers,
#                         the dense one and 4 MoE (2.84 G parameters, ~51 GB
#                         of training state; all 27 need ~283 GB)
SSD_BWD_TOL = 2e-2      # the SSD backward, bf16 inputs, of each grad's scale
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
ATTN_TOL = dict(rtol=2e-2, atol=2e-2)   # bf16 inputs (tests/test_kernels.py)
SSD_TOL = dict(rtol=3e-2, atol=3e-2)    # bf16 inputs (tests/test_kernels.py)
ML_TOL = dict(rtol=1e-5, atol=1e-5)     # f32 accumulators, other sum order
# Query scale of phase 3's flash checks at the new families' shapes.  At
# unit scale the softmax over thousands of keys is near uniform and every
# output is a mean of ~Tk values (about 0.03), under ATTN_TOL; at 3 the
# scores are N(0, 9), a few keys carry each row, the outputs are O(1), and
# a skipped or mis-masked key tile moves rows by far more than ATTN_TOL.
PEAK_Q = 3.0

MODES = ("sync", "async", "fused")
SSM_MODES = ("sync", "async")
REPLACES = {
    "paged_attention": "src/repro/kernels/paged_attention.py:106",
    "paged_attention.page": "src/repro/kernels/paged_attention.py:106",
    "paged_attention.frame": "src/repro/kernels/paged_attention.py:106",
    "paged_attention.fused": "src/repro/kernels/paged_attention.py:293",
    "page_gather": "src/repro/kernels/page_compact.py:92",
    "page_scatter": "src/repro/kernels/page_compact.py:128",
    "page_compact": "src/repro/kernels/page_compact.py:40",
    "flash_attention": "src/repro/kernels/flash_attention.py:82",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:73",
    "flash_attention_bwd": "repro/models/layers.py:118 attention, "
                           "differentiated by jax.value_and_grad "
                           "(repro/train/trainer.py:155)",
    "ssd_scan_bwd": "src/repro/models/mamba2.py:96 ssd_chunked (the oracle "
                    "of src/repro/kernels/ssd_scan.py:73), differentiated by "
                    "jax.value_and_grad (src/repro/train/trainer.py:155)",
    "adamw": "src/repro/train/optimizer.py:48 upd, fused by XLA in the "
             "jitted train_step (src/repro/train/trainer.py:150)",
    "grad_quant": "src/repro/train/grad_compress.py:90 "
                  "compressed_allreduce_flat (with _quant / _dequant, "
                  ":31-41), fused by XLA in the jitted train_step "
                  "(src/repro/train/trainer.py:150)",
}
SOURCES = {
    "paged_attention": "src/repro_torch/csrc/paged_attention.cu",
    "paged_attention.page": "src/repro_torch/csrc/paged_attention.cu",
    "paged_attention.frame": "src/repro_torch/csrc/paged_attention.cu",
    "paged_attention.fused": "src/repro_torch/csrc/paged_attention.cu",
    "page_gather": "src/repro_torch/csrc/page_copy.cu",
    "page_scatter": "src/repro_torch/csrc/page_copy.cu",
    "page_compact": "src/repro_torch/csrc/page_copy.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "ssd_scan": "src/repro_torch/csrc/ssd_scan.cu",
    "flash_attention_bwd": "src/repro_torch/csrc/flash_attention_bwd.cu",
    "ssd_scan_bwd": "src/repro_torch/csrc/ssd_scan_bwd.cu",
    "adamw": "src/repro_torch/csrc/adamw.cu",
    "grad_quant": "src/repro_torch/csrc/grad_quant.cu",
}


class SmokeFailure(RuntimeError):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------- workload


def make_stream(vocab: int, seed: int = 0):
    """[(arrival_step, Request)]: 8 requests over 3 tenants.

    Request 0 (priority 2) has a 1100-token prompt, so it spans one full,
    coalesced 16-page frame plus a partial one; requests 1-5 (priority 0)
    have 128-768-token prompts; requests 6-7 (priority 1) arrive at
    ``ARRIVE_STEP`` and displace lower-priority work.  Lengths are drawn
    before tokens, so the schedule (which depends on lengths only) is the
    same at every model width.
    """
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    lens = ([1100] + [int(rng.integers(128, 769)) for _ in range(5)]
            + [int(rng.integers(384, 769)) for _ in range(2)])
    news = [64] + [int(rng.integers(32, 65)) for _ in range(7)]
    prio = [2, 0, 0, 0, 0, 0, 1, 1]
    arrive = [0] * 6 + [ARRIVE_STEP] * 2
    return [(arrive[i], Request(
        rid=i, tenant=i % 3, priority=prio[i], max_new=news[i],
        prompt=rng.integers(0, vocab, lens[i]).astype(np.int32)))
        for i in range(8)]


def make_prefix_waves(vocab: int, seed: int = 1):
    """Phase 4b's requests as two waves: six requests over three tenants,
    each a shared ``PREFIX_TOKENS``-token system prompt followed by its own
    64-256-token suffix (distinct lengths), ``PREFIX_NEW`` new tokens."""
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, PREFIX_TOKENS).astype(np.int32)
    lens = rng.permutation(np.arange(64, 257))[:6]
    reqs = [Request(rid=i, tenant=i % 3, max_new=PREFIX_NEW,
                    prompt=np.concatenate([shared, rng.integers(
                        0, vocab, int(n)).astype(np.int32)]))
            for i, n in enumerate(lens)]
    return reqs[:2], reqs[2:]


def drive(eng, stream, hook=None, max_steps: int = 4000):
    """Submit each request at its arrival step; step until drained.

    ``hook(step, eng)`` runs before each step.  Returns the decode batch
    (the rids that gained a token) of every step.
    """
    pending = sorted(stream, key=lambda a: a[0])
    reqs = [r for _, r in stream]
    batches = []
    step = 0
    while pending or eng.queue or eng.active or eng.preempted:
        require(step < max_steps, f"engine not drained in {max_steps} steps")
        while pending and pending[0][0] <= step:
            eng.submit(pending.pop(0)[1])
        if hook is not None:
            hook(step, eng)
        before = [len(r.out) for r in reqs]
        eng.step()
        batches.append(tuple(r.rid for r, n in zip(reqs, before)
                             if len(r.out) > n))
        step += 1
    return batches


class MainPathEvents:
    """Step hook of the main path (device-agnostic, also run on the CPU).

    At ``PROBE_STEP``: dual-granularity attention (frames + pages, the
    port's kernels on CUDA tensors) over layer 0 of the engine's pool,
    through ``pack_dual`` tables of the active requests, held against the
    plain page-only version over the same sequences.  At ``TRIM_STEP``:
    partial deallocation of request 0's pages ``TRIM_VPNS``
    (``MosaicManager.free_pages``, the paper's partial-deallocation path):
    the frame loses its coalesced bit and CAC plans copies out of the
    owner's fragmented frames, which the engine executes with page_compact
    in its next step.  One step later every surviving page of request 0
    must hold its bytes at its (possibly new) physical page.
    """

    def __init__(self, cfg):
        self.cfg = cfg
        self.first_len = None     # request 0's pool tokens at step 1
        self.probe_frames = 0
        self.probe_err = float("nan")
        self.cac_checked = False
        self._snap = {}
        self._tokens = 0

    def __call__(self, step, eng):
        if step == 1:
            self.first_len = eng.cache.seq_tokens.get(0)
        if step == PROBE_STEP:
            self._probe(eng)
        elif step == TRIM_STEP:
            self._trim(eng)
        elif step == TRIM_STEP + 1:
            self._check_cac(eng)

    def _probe(self, eng):
        import torch
        from repro_torch.kernels import ops, ref
        cfg, fp = self.cfg, eng.geo.frame_pages
        seqs = [r.rid for r in eng.active]
        ft, fn, pt, pn = eng.cache.pack_dual(
            seqs, 0, max_frames=eng.mpps // fp, max_pages=eng.mpps,
            device=eng.device)
        ctx = eng.cache.pack_ctx(seqs, eng.mpps, device=eng.device)
        gen = torch.Generator(device=eng.device).manual_seed(2)
        k, v = eng.pools
        # The query is as wide as the K pool (MLA: latent + rope).
        q = torch.randn((len(seqs), cfg.n_heads, k.shape[-1]),
                        generator=gen, device=eng.device).to(torch.bfloat16)
        scale = k.shape[-1] ** -0.5
        dual = ops.paged_attention_dual(q, k[0], v[0], ft, fn, pt, pn,
                                        frame_pages=fp, scale=scale)
        plain = ref.paged_attention_full_ref(
            q, k[0], v[0], ctx.tables.reshape(len(seqs), -1),
            ctx.ntok.reshape(len(seqs), -1), scale=scale)
        torch.testing.assert_close(dual, plain, **ATTN_TOL)
        self.probe_frames = int((ft >= 0).sum())
        self.probe_err = float((dual - plain).abs().max())

    def _trim(self, eng):
        mgr = eng.cache.mgrs[0]
        table = mgr.tables.get(0)
        require(table is not None and len(table.ppn) > eng.geo.frame_pages
                and table.coalesced[0],
                "request 0 must hold a coalesced frame and a partial one")
        k, v = eng.pools
        self._snap = {vpn: (k[:, ppn].clone(), v[:, ppn].clone())
                      for vpn, ppn in enumerate(table.ppn)
                      if vpn not in TRIM_VPNS}
        self._tokens = eng.cache.seq_tokens[0]
        mgr.free_pages(0, list(TRIM_VPNS))

    def _check_cac(self, eng):
        import torch
        table = eng.cache.mgrs[0].tables.get(0)
        require(table is not None, "request 0 left the pool before the check")
        ptok = eng.geo.page_tokens
        k, v = eng.pools
        for vpn, (kp, vp) in self._snap.items():
            n = min(ptok, self._tokens - vpn * ptok)
            ppn = table.ppn[vpn]
            require(torch.equal(k[:, ppn, :n], kp[:, :n])
                    and torch.equal(v[:, ppn, :n], vp[:, :n]),
                    f"CAC moved page {vpn} of request 0 incoherently")
        self.cac_checked = True


# ---------------------------------------------------------------- timing


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device ms per call: ``reps`` calls captured in one CUDA graph,
    replayed; launch overhead is outside the measurement."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (reps * replays)


def eager_ms(fn, iters: int = 20) -> float:
    """Wall ms per call on the card's clock (CUDA events), after warm-up;
    includes the host work between launches."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def cycling(fn, arg_sets):
    """A callable that applies ``fn`` to each argument tuple in turn."""
    it = itertools.cycle(arg_sets)
    return lambda: fn(*next(it))


def bound_ms(nbytes: float, flops: float = 0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- phases


SMI = "card not read"     # phase_env's nvidia-smi name, power limit


def phase_env():
    global SMI
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    SMI = smi.stdout.strip().splitlines()[0]
    print(SMI)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    print(f"[build] {build.BUILD_INFO['built']} sources in "
          f"{time.perf_counter() - t0:.1f}s -> {build.BUILD_INFO['directory']}")
    for name, log in build.BUILD_INFO["ptxas"].items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def _tables(rng, B, n_blocks, n_entries, tokens_per_block, *, holes=True):
    """Random block tables with holes and partial last blocks."""
    tables = np.full((B, n_blocks), -1, np.int32)
    ntok = np.zeros((B, n_blocks), np.int32)
    for b in range(B):
        used = int(rng.integers(1, n_blocks + 1))
        ids = rng.permutation(n_entries)[:used]
        slots = np.sort(rng.permutation(n_blocks)[:used]) if holes \
            else np.arange(used)
        for j, (slot, e) in enumerate(zip(slots, ids)):
            tables[b, slot] = e
            ntok[b, slot] = tokens_per_block if j < used - 1 else int(
                rng.integers(1, tokens_per_block + 1))
    return tables, ntok


def phase_kernels(cfg, results):
    """Each kernel against its plain version at the serving shapes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.hybrid import n_invocations
    dev = torch.device("cuda")
    geo = PoolGeometry()
    ptok, fp = geo.page_tokens, geo.frame_pages
    n_kv, dh, H = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_heads
    L = cfg.n_layers
    NP = 80                       # the main path's pool: 2x oversubscribed
    mpps = MAX_SEQ // ptok        # page-table width at max_seq
    rng = np.random.default_rng(1)
    gen = torch.Generator(device=dev).manual_seed(1)
    scale = dh ** -0.5

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    pool_k, pool_v = randn(NP, ptok, n_kv, dh), randn(NP, ptok, n_kv, dh)

    def t(a):
        return torch.from_numpy(a).to(dev)

    paged_entries(results, H, n_kv, dh, L, "", rng, randn)

    # Frames combined with pages == page-only over the same sequences.
    B = MAX_BATCH
    q = randn(B, H, dh)
    ft, fn = _tables(rng, B, 2, NP // fp, fp * ptok, holes=False)
    fn[:] = fp * ptok                              # coalesced frames are full
    pages = np.full((B, mpps), -1, np.int32)
    pn = np.zeros((B, mpps), np.int32)
    perm = rng.permutation(NP)
    for b in range(B):
        n = int(rng.integers(1, 9))
        pages[b, :n] = perm[b * 8:b * 8 + n]
        pn[b, :n] = ptok
        pn[b, n - 1] = int(rng.integers(1, ptok + 1))
    dual = ops.paged_attention_dual(q, pool_k, pool_v, t(ft), t(fn),
                                    t(pages), t(pn), frame_pages=fp,
                                    scale=scale)
    ft_pages, fn_pages = ref.frames_to_pages(t(ft), t(fn), frame_pages=fp,
                                             page_tokens=ptok)
    o, m, l = ops.paged_attention_kernel(
        q, pool_k, pool_v, torch.cat([ft_pages, t(pages)], 1).contiguous(),
        torch.cat([fn_pages, t(pn)], 1).contiguous(), granularity="page",
        scale=scale)
    torch.testing.assert_close(dual, o / l[..., None], **ATTN_TOL)
    print("[kernel] frames+pages == page-only on the same sequences: ok")

    fused_entry(results, H, n_kv, dh, L, "", rng, randn)

    # Prefill flash attention at the path's shapes: (a) a full FLASH_T-token
    # prompt, (b) its suffix from position FLASH_P over all FLASH_T keys (a
    # cache hit on a FLASH_P-token prefix).  Compute-bound: its bound is
    # the bf16 operations of the causal pairs at the tensor-core peak.
    import torch.nn.functional as F
    name = "flash_attention"
    T, P = FLASH_T, FLASH_P
    q, k, v = randn(1, T, H, dh), randn(1, T, n_kv, dh), randn(1, T, n_kv, dh)
    qs = q[:, P:].contiguous()
    full = ops.flash_attention(q, k, v)
    suffix = ops.flash_attention(qs, k, v, q_offset=P)
    plain_full = ref.flash_attention_ref(q, k, v, causal=True)
    plain_suffix = ref.flash_attention_ref(qs, k, v, causal=True, q_offset=P)
    torch.cuda.synchronize()
    errs = []
    for got, want in ((full, plain_full), (suffix, plain_suffix)):
        torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL)
        require(bool(torch.isfinite(got.float()).all()), f"{name}: "
                f"non-finite")
        errs.append(float((got.float() - want.float()).abs().max()))
    require(torch.equal(suffix, full[:, P:]), f"{name}: suffix rows are not "
            f"the full call's bit for bit")

    def flash_bound(tq):
        """Bytes (q, k, v read once, o written once) and operations (QK^T
        and PV over the causal pairs) of queries T - tq .. T - 1."""
        pairs = sum(range(T - tq + 1, T + 1))
        return bound_ms(2 * (2 * tq * H + 2 * T * n_kv) * dh,
                        4 * H * dh * pairs)
    b_ms, b_by = flash_bound(T)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    results[name] = dict(
        max_abs_err=max(errs),
        ms=graph_ms(lambda: ops.flash_attention(q, k, v)),
        plain_ms=eager_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                          causal=True)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        shape=f"B=1 H={H} n_kv={n_kv} dh={dh} T={T} causal")
    r = results[name]
    sb_ms, _ = flash_bound(T - P)
    s_ms = graph_ms(lambda: ops.flash_attention(qs, k, v, q_offset=P))
    print(f"[kernel] {name}: max_abs_err {r['max_abs_err']:.3g}, suffix "
          f"rows bitwise == full | (a) full: kernel_ms {r['ms']:.4f} "
          f"plain_ms {r['plain_ms']:.4f} bound_ms {r['bound_ms']:.5f} "
          f"({r['bound_by']}) library_ms {r['library_ms']:.4f} "
          f"(scaled_dot_product_attention) | (b) suffix Tq={T - P} "
          f"q_offset={P}: kernel_ms {s_ms:.4f} bound_ms {sb_ms:.5f} | "
          f"{r['shape']} | {flash_tiles(H, n_kv, T)}")
    hyb = get_config(HYBRID_ARCH)
    phase_attention_at(gen, hyb, n_invocations(hyb), "zamba2 shared block")
    phase_attention_at(gen, get_config(MOE_ARCH), MOE_LAYERS, "dbrx")

    # Copies on the engine's stacked pools [L, NP, ptok, n_kv, dh].
    pool = randn(L, NP, ptok, n_kv, dh)
    check_copies(pool, rng, randn, "qwen2.5-3b")
    copy_entries(results, pool, rng, randn)
    torch.cuda.synchronize()


def paged_entries(results, H, n_kv, dh, L, suffix, rng, randn,
                  grans=("page", "frame")):
    """Paged attention at ``grans`` granularities, B in {1, 4, 8}, over an
    80-page pool with holes and partial last blocks (B = 8: a row made only
    of holes), against its plain version (o / l, m and l: f32 accumulators
    in another order, so at ML_TOL, far below the outputs' scale); timed at
    B = MAX_BATCH and B = 1 cycling over ``L`` layers' pools as decode
    reads them (beyond the 50 MB L2).  Stores ``paged_attention.<granularity><suffix>`` in ``results``
    and prints a [kernel] line for each."""
    import torch
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    geo = PoolGeometry()
    ptok, fp = geo.page_tokens, geo.frame_pages
    NP, mpps = 80, MAX_SEQ // ptok
    scale = dh ** -0.5
    kall, vall = randn(L, NP, ptok, n_kv, dh), randn(L, NP, ptok, n_kv, dh)
    pool_k, pool_v = kall[0], vall[0]

    def t(a):
        return torch.from_numpy(a).to(kall.device)
    for gran, n_blocks, n_entries, tpb in (
            ("page", mpps, NP, ptok), ("frame", mpps // fp, NP // fp,
                                       fp * ptok)):
        if gran not in grans:
            continue
        name = f"paged_attention.{gran}{suffix}"
        errs, o_scale = [], 0.0
        for B in (1, 4, 8):
            q = randn(B, H, dh)
            tb, nt = _tables(rng, B, n_blocks, n_entries, tpb)
            if B == 8:
                tb[-1], nt[-1] = -1, 0          # a row made only of holes
            tb, nt = t(tb), t(nt)
            o, m, l = ops.paged_attention_kernel(
                q, pool_k, pool_v, tb, nt, granularity=gran,
                frame_pages=fp, scale=scale)
            o_r, m_r, l_r = ref.paged_attention_ref(
                q, pool_k, pool_v, tb, nt, scale=scale,
                frame_pages=fp if gran == "frame" else 1)
            torch.cuda.synchronize()
            on = o / torch.clamp(l[..., None], min=1e-30)
            on_r = o_r / torch.clamp(l_r[..., None], min=1e-30)
            torch.testing.assert_close(on, on_r, **ML_TOL)
            torch.testing.assert_close(m, m_r, **ML_TOL)
            torch.testing.assert_close(l, l_r, **ML_TOL)
            require(bool(torch.isfinite(on).all()), f"{name}: non-finite")
            if B == 8:
                require(bool((m[-1] == -1e30).all() and (l[-1] == 0).all()
                             and (o[-1] == 0).all()),
                        f"{name}: all-hole row must give m=-1e30, l=0, o=0")
            errs.append(float((on - on_r).abs().max()))
            o_scale = max(o_scale, float(on_r.abs().max()))
            if B == 1:
                # A lone decoding request, over all L layers' pools in turn.
                b1_ms = graph_ms(cycling(functools.partial(
                    ops.paged_attention_kernel, granularity=gran,
                    frame_pages=fp, scale=scale),
                    [(q, kall[i], vall[i], tb, nt) for i in range(L)]))
                b1_tokens = int(nt.sum())
            if B == MAX_BATCH:
                # Timed over all L layers' pools in turn, as decode reads
                # them: 2 x 94 MB, beyond the 50 MB L2.
                tokens = int(nt.sum())
                nbytes = (2 * tokens * n_kv * dh * 2 + q.numel() * 2
                          + 2 * tb.numel() * 4 + B * H * (dh + 2) * 4)
                b_ms, b_by = bound_ms(nbytes, 4 * H * dh * tokens)
                layers = [(q, kall[i], vall[i], tb, nt) for i in range(L)]
                kw = dict(scale=scale)
                timing = dict(
                    ms=graph_ms(cycling(functools.partial(
                        ops.paged_attention_kernel, granularity=gran,
                        frame_pages=fp, **kw), layers)),
                    plain_ms=eager_ms(cycling(functools.partial(
                        ref.paged_attention_ref,
                        frame_pages=fp if gran == "frame" else 1, **kw),
                        layers)),
                    bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    shape=f"B={B} H={H} n_kv={n_kv} dh={dh} "
                          f"blocks={n_blocks} tokens={tokens}")
        results[name] = dict(max_abs_err=max(errs), **timing)
        print(f"[kernel] {name}: max_abs_err {max(errs):.3g} (output scale "
              f"{o_scale:.3g}) | kernel_ms {timing['ms']:.4f} plain_ms "
              f"{timing['plain_ms']:.4f} bound_ms {timing['bound_ms']:.5f} "
              f"library_ms none (no single PyTorch call computes paged "
              f"attention) | {timing['shape']} | splits "
              f"{pa.split_count(n_blocks, tpb)} of {pa.SPLIT_TOKENS} "
              f"positions, grid {pa.split_count(n_blocks, tpb)}x{n_kv}x"
              f"{MAX_BATCH} + combine | B=1 ({b1_tokens} tokens): kernel_ms "
              f"{b1_ms:.4f}")


def fused_entry(results, H, n_kv, dh, L, suffix, rng, randn,
                max_seq=MAX_SEQ):
    """Fused gather-attend at B = MAX_BATCH over an 80-page pool with
    about half of the valid pages staged and page tables as wide as
    ``max_seq``, against its plain version (o / l and m, l at the f32
    tolerance) and bit for bit against the page kernel where it reads the
    same bytes, staged or not; timed cycling over ``L`` layers' pools and
    stages as decode reads them.  Stores ``paged_attention.fused<suffix>``
    in ``results``."""
    import torch
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    name = f"paged_attention.fused{suffix}"
    NP, ptok, B = 80, PoolGeometry().page_tokens, MAX_BATCH
    n_blocks = max_seq // ptok
    scale = dh ** -0.5
    kall, vall = randn(L, NP, ptok, n_kv, dh), randn(L, NP, ptok, n_kv, dh)

    def t(a):
        return torch.from_numpy(a).to(kall.device)
    # The stage holds each staged page's bytes; the pool copies are
    # overwritten, so reading the wrong source shows.
    q = randn(B, H, dh)
    tb, nt = _tables(rng, B, n_blocks, NP, ptok)
    late = (tb >= 0) & (rng.random(tb.shape) < 0.5)
    n_staged = int(late.sum())
    require(0 < n_staged < int((tb >= 0).sum()), "fused case stages no page")
    slots = np.full(tb.shape, -1, np.int32)
    slots[late] = np.arange(n_staged, dtype=np.int32)
    ids = t(tb[late]).long()
    tb, nt, sl = t(tb), t(nt), t(slots)
    st_k, st_v = kall[:, ids].contiguous(), vall[:, ids].contiguous()
    pk0, pv0 = kall[0].clone(), vall[0].clone()
    pk0[ids], pv0[ids] = randn(n_staged, ptok, n_kv, dh), \
        randn(n_staged, ptok, n_kv, dh)
    args = (q, pk0, pv0, st_k[0], st_v[0], tb, sl, nt)
    o, m, l = ops.fused_paged_attention_kernel(*args, scale=scale)
    o_r, m_r, l_r = ref.fused_paged_attention_ref(*args, scale=scale)
    torch.cuda.synchronize()
    on, on_r = o / l[..., None], o_r / l_r[..., None]
    torch.testing.assert_close(on, on_r, **ML_TOL)
    torch.testing.assert_close(m, m_r, **ML_TOL)
    torch.testing.assert_close(l, l_r, **ML_TOL)
    require(bool(torch.isfinite(on).all()), f"{name}: non-finite")
    # Same bytes as the page kernel reads: bit for bit, staged or not.
    base = ops.paged_attention_kernel(q, kall[0], vall[0], tb, nt,
                                      granularity="page", scale=scale)
    for sl_case in (sl, torch.full_like(sl, -1)):
        got = ops.fused_paged_attention_kernel(
            q, kall[0], vall[0], st_k[0], st_v[0], tb, sl_case, nt,
            scale=scale)
        require(all(torch.equal(a, b) for a, b in zip(got, base)),
                f"{name}: not bitwise the page kernel on the same bytes")
    tokens = int(nt.sum())
    nbytes = (2 * tokens * n_kv * dh * 2 + q.numel() * 2
              + 3 * tb.numel() * 4 + B * H * (dh + 2) * 4)
    b_ms, b_by = bound_ms(nbytes, 4 * H * dh * tokens)
    # Timed over all L layers' pools and stages in turn, as decode reads
    # them, beyond the 50 MB L2.
    layers = [(q, kall[i], vall[i], st_k[i], st_v[i], tb, sl, nt)
              for i in range(L)]
    results[name] = dict(
        max_abs_err=float((on - on_r).abs().max()),
        ms=graph_ms(cycling(functools.partial(
            ops.fused_paged_attention_kernel, scale=scale), layers)),
        plain_ms=eager_ms(cycling(functools.partial(
            ref.fused_paged_attention_ref, scale=scale), layers)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"B={B} H={H} n_kv={n_kv} dh={dh} blocks={n_blocks} "
              f"tokens={tokens} staged={n_staged}/{int((tb >= 0).sum())}")
    r = results[name]
    print(f"[kernel] {name}: max_abs_err {r['max_abs_err']:.3g} (output "
          f"scale {float(on_r.abs().max()):.3g}), bitwise == page kernel on "
          f"the same bytes | kernel_ms {r['ms']:.4f} plain_ms "
          f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.5f} library_ms none "
          f"(no single PyTorch call computes it) | {r['shape']} | splits "
          f"{pa.split_count(n_blocks, ptok)} of {pa.SPLIT_TOKENS} positions "
          f"+ combine")


def flash_tiles(H, n_kv, T):
    """The flash kernel's tiling for one T-token prompt (B = 1), for the
    [kernel] lines."""
    g = H // n_kv
    bq = 64 // g
    return (f"tiles 64 rows ({g} heads x {bq} positions) x 64 keys, "
            f"mma.sync m16n8k16 bf16, grid {-(-T // bq)}x{n_kv}x1")


def copy_entries(results, pool, rng, randn, suffix="", n_pages=13):
    """page_gather, page_scatter and page_compact on the stacked pool
    ``pool`` [L, NP, ptok, n_kv, dh] (bf16), timed beside their bounds,
    plain versions and library calls: entries ``<kernel><suffix>``.  The
    gathers and scatters take ``n_pages`` pages with a hole (13: a
    768-token prompt + 64 new tokens at 64-token pages), compactions 4
    copies with two holes."""
    import torch
    from repro_torch.kernels import ops, ref
    dev = pool.device
    L, NP, ptok, n_kv, dh = pool.shape

    def t(a):
        return torch.from_numpy(a).to(dev)
    perm = rng.permutation(NP)
    page_bytes = ptok * n_kv * dh * 2
    n_valid = n_pages - 1         # every timed set has one hole
    # Timed calls cycle over disjoint page sets covering the whole pool
    # (qwen2.5-3b's: 94 MB, beyond the 50 MB L2), as evictions and faults
    # find it cold.
    idx_sets = [perm[i * n_pages:(i + 1) * n_pages].astype(np.int32)
                for i in range(NP // n_pages)]
    for s_ in idx_sets:
        s_[3] = -1
    idx_sets = [t(s_) for s_ in idx_sets]
    b_ms, b_by = bound_ms(2 * L * n_pages * page_bytes)
    results["page_gather" + suffix] = dict(
        max_abs_err=0.0,
        ms=graph_ms(cycling(ops.page_gather, [(pool, i) for i in idx_sets])),
        plain_ms=eager_ms(cycling(ref.page_gather_ref,
                                  [(pool, i) for i in idx_sets])),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(cycling(
            torch.index_select, [(pool, 1, i.clamp(min=0))
                                 for i in idx_sets])),
        shape=f"L={L} n={n_pages} page={page_bytes}B")

    a, b_ = pool.clone(), pool.clone()
    page_sets = [randn(L, n_pages, ptok, n_kv, dh) for _ in idx_sets]
    keep_col = torch.arange(n_pages, device=dev) != 3
    b_ms, b_by = bound_ms(2 * L * n_valid * page_bytes)
    results["page_scatter" + suffix] = dict(
        max_abs_err=0.0,
        ms=graph_ms(cycling(ops.page_scatter,
                            [(a, i, pg) for i, pg in zip(idx_sets,
                                                         page_sets)])),
        plain_ms=eager_ms(cycling(ref.page_scatter_ref,
                                  [(b_, i, pg) for i, pg in zip(idx_sets,
                                                                page_sets)])),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(cycling(
            a.index_copy_, [(1, i[keep_col].long(),
                             pg[:, keep_col].contiguous())
                            for i, pg in zip(idx_sets, page_sets)])),
        shape=f"L={L} n={n_pages} ({n_valid} valid) page={page_bytes}B")

    n_copy, n_ok = 4, 2           # every timed plan has two holes
    pairs = []
    for i in range(NP // (2 * n_copy)):
        chunk = perm[i * 2 * n_copy:(i + 1) * 2 * n_copy].astype(np.int32)
        s_, d_ = chunk[:n_copy].copy(), chunk[n_copy:].copy()
        s_[1] = d_[2] = -1
        pairs.append((t(s_), t(d_)))
    ok_col = torch.tensor([0, 3], device=dev)

    def lib_compact(s_, d_):
        a[:, d_] = a[:, s_]
    b_ms, b_by = bound_ms(2 * L * n_ok * page_bytes)
    results["page_compact" + suffix] = dict(
        max_abs_err=0.0,
        ms=graph_ms(cycling(ops.page_compact, [(a, s_, d_)
                                               for s_, d_ in pairs])),
        plain_ms=eager_ms(cycling(ref.page_compact_ref,
                                  [(b_, s_, d_) for s_, d_ in pairs])),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(cycling(lib_compact, [
            (s_[ok_col].long(), d_[ok_col].long()) for s_, d_ in pairs])),
        shape=f"L={L} n={n_copy} ({n_ok} valid) page={page_bytes}B")
    for name in ("page_gather", "page_scatter", "page_compact"):
        r = results[name + suffix]
        print(f"[kernel] {name}{suffix}: exact | kernel_ms {r['ms']:.4f} "
              f"plain_ms {r['plain_ms']:.4f} bound_ms {r['bound_ms']:.5f} "
              f"library_ms {r['library_ms']:.4f} | {r['shape']}")


def check_copies(pool, rng, randn, label):
    """page_gather, page_scatter and page_compact on the stacked pool
    ``pool`` [L, NP, ...] against their plain versions, exactly: 13 pages
    with a hole, 4 copies with a hole on each side, and all-hole calls,
    which must copy nothing."""
    import torch
    from repro_torch.kernels import ops, ref
    dev = pool.device

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    perm = rng.permutation(pool.shape[1])
    idx = perm[:13].copy()
    idx[3] = -1
    require(torch.equal(ops.page_gather(pool, t(idx)),
                        ref.page_gather_ref(pool, t(idx))),
            f"page_gather != plain ({label})")
    require(torch.equal(ops.page_gather(pool, t(np.full(4, -1))),
                        pool[:, [0, 0, 0, 0]]), f"page_gather all-hole "
            f"({label})")
    pages = randn(pool.shape[0], 13, *pool.shape[2:])
    a, b = pool.clone(), pool.clone()
    ops.page_scatter(a, t(idx), pages)
    ref.page_scatter_ref(b, t(idx), pages)
    require(torch.equal(a, b), f"page_scatter != plain ({label})")
    ops.page_scatter(a, t(np.full(5, -1)), pages[:, :5].contiguous())
    require(torch.equal(a, b), f"page_scatter all-hole must be a no-op "
            f"({label})")
    src, dst = perm[13:17].copy(), perm[17:21].copy()
    src[1] = dst[2] = -1
    ops.page_compact(a, t(src), t(dst))
    ref.page_compact_ref(b, t(src), t(dst))
    require(torch.equal(a, b), f"page_compact != plain ({label})")
    ops.page_compact(a, t(np.full(3, -1)), t(np.full(3, -1)))
    require(torch.equal(a, b), f"page_compact all-hole must be a no-op "
            f"({label})")
    page = pool[0, 0].numel() * pool.element_size()
    print(f"[kernel] page_gather / page_scatter / page_compact ({label}): "
          f"exact | L={pool.shape[0]} page={page}B")


def phase_attention_at(gen, cfg, n_slices, label):
    """Flash and paged attention at ``cfg``'s attention shapes, against
    their plain versions and timed beside their bounds: flash on a
    FLASH_T-token prompt and its suffix from FLASH_P (rows bitwise the full
    call's); paged (page granularity) at B = 1 and B = MAX_BATCH over the
    main path's table width, timed cycling over ``n_slices`` pool slices
    (zamba2's 6 shared-block invocations, dbrx's 8 layers) as a decode
    step does; then the page copies on those slices.  Printed only: the
    kernels JSON line keeps the serving shapes of qwen2.5-3b."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    dev = torch.device("cuda")
    H, n_kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    geo = PoolGeometry()
    ptok = geo.page_tokens
    NP, mpps, T, P = 80, MAX_SEQ // ptok, FLASH_T, FLASH_P
    scale = dh ** -0.5

    def randn(*shape):
        return torch.randn(shape, generator=gen,
                           device=dev).to(torch.bfloat16)
    q, k, v = randn(1, T, H, dh), randn(1, T, n_kv, dh), randn(1, T, n_kv, dh)
    qs = q[:, P:].contiguous()
    got = ops.flash_attention(q, k, v)
    suffix = ops.flash_attention(qs, k, v, q_offset=P)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL)
    require(torch.equal(suffix, got[:, P:]), f"flash_attention ({label}): "
            f"suffix rows are not the full call's bit for bit")
    err = float((got.float() - want.float()).abs().max())
    pairs = T * (T + 1) // 2
    b_ms, b_by = bound_ms(2 * (2 * T * H + 2 * T * n_kv) * dh,
                          4 * H * dh * pairs)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms = graph_ms(lambda: ops.flash_attention(q, k, v))
    lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    print(f"[kernel] flash_attention ({label}): max_abs_err {err:.3g}, "
          f"suffix rows bitwise == full | kernel_ms {ms:.4f} bound_ms "
          f"{b_ms:.5f} ({b_by}) library_ms {lib_ms:.4f} "
          f"(scaled_dot_product_attention) | B=1 H={H} n_kv={n_kv} dh={dh} "
          f"T={T} causal | {flash_tiles(H, n_kv, T)}")

    rng = np.random.default_rng(4)
    kall, vall = (randn(n_slices, NP, ptok, n_kv, dh) for _ in range(2))
    errs = []
    for B in (1, MAX_BATCH):
        qd = randn(B, H, dh)
        tb, nt = (torch.from_numpy(a).to(dev)
                  for a in _tables(rng, B, mpps, NP, ptok))
        o, m, l = ops.paged_attention_kernel(qd, kall[0], vall[0], tb, nt,
                                             granularity="page", scale=scale)
        o_r, m_r, l_r = ref.paged_attention_ref(qd, kall[0], vall[0], tb, nt,
                                                scale=scale)
        torch.cuda.synchronize()
        on, on_r = o / l[..., None], o_r / l_r[..., None]
        torch.testing.assert_close(on, on_r, **ATTN_TOL)
        torch.testing.assert_close(m, m_r, **ML_TOL)
        torch.testing.assert_close(l, l_r, **ML_TOL)
        errs.append(float((on - on_r).abs().max()))
    tokens = int(nt.sum())
    b_ms, b_by = bound_ms(2 * tokens * n_kv * dh * 2 + qd.numel() * 2
                          + 2 * tb.numel() * 4 + B * H * (dh + 2) * 4,
                          4 * H * dh * tokens)
    ms = graph_ms(cycling(functools.partial(
        ops.paged_attention_kernel, granularity="page", scale=scale),
        [(qd, kall[i], vall[i], tb, nt) for i in range(n_slices)]))
    ns = pa.split_count(mpps, ptok)
    print(f"[kernel] paged_attention.page ({label}): max_abs_err "
          f"{max(errs):.3g} (B = 1 and {B}) | kernel_ms {ms:.4f} bound_ms "
          f"{b_ms:.5f} ({b_by}) | B={B} H={H} n_kv={n_kv} dh={dh} "
          f"blocks={mpps} tokens={tokens}, cycling {n_slices} pool slices | "
          f"splits {ns} of {pa.SPLIT_TOKENS} positions, grid "
          f"{ns}x{n_kv}x{B} + combine")
    check_copies(kall, rng, randn, label)


def phase_mla_kernels(results):
    """Paged and flash attention at deepseek-v2-lite's MLA shapes, against
    their plain versions and timed beside their bounds.  Paged (absorbed
    decode): 16 query heads on one latent KV head, K 576 / V 512, bf16,
    64-token pages, 32 pages (2 frames) per row, holes and partial pages,
    at B = MAX_BATCH and B = 1, cycling over the 27 layers' pools as a
    decode step reads them (300 MB, beyond the 50 MB L2).  Flash (expanded
    prefill): H = n_kv = 16, dh 192 / dh_v 128, a FLASH_T-token causal
    prompt, and its suffix from FLASH_P, whose rows must equal the full
    call's bit for bit.  Each becomes its own entry of the kernels line
    (``<kernel>.mla``), launches counted in phase 4e.  Then the page copies
    on the stacked latent pools (K pages of 73,728 B, V of 65,536 B)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    dev = torch.device("cuda")
    mcfg = get_config(MLA_ARCH)
    m = mcfg.mla
    H, L = mcfg.n_heads, mcfg.n_layers
    dk, dv = m.kv_lora_rank + m.qk_rope_head_dim, m.kv_lora_rank
    dq = m.qk_nope_head_dim + m.qk_rope_head_dim
    scale = dq ** -0.5
    geo = PoolGeometry()
    ptok, fp = geo.page_tokens, geo.frame_pages
    NP, mpps = 80, MAX_SEQ // ptok
    rng = np.random.default_rng(5)
    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen,
                           device=dev).to(torch.bfloat16)

    def t(a):
        return torch.from_numpy(a).to(dev)
    kall, vall = randn(L, NP, ptok, 1, dk), randn(L, NP, ptok, 1, dv)
    pools = [(kall[i], vall[i]) for i in range(L)]
    for gran, n_blocks, n_entries, tpb in (
            ("page", mpps, NP, ptok), ("frame", mpps // fp, NP // fp,
                                       fp * ptok)):
        name = f"paged_attention.{gran}.mla"
        fpk = fp if gran == "frame" else 1
        errs, times = [], {}
        for B in (1, MAX_BATCH):
            q = randn(B, H, dk)
            tb, nt = _tables(rng, B, n_blocks, n_entries, tpb)
            if B == MAX_BATCH:
                tb[-1], nt[-1] = -1, 0          # a row made only of holes
            tb, nt = t(tb), t(nt)
            o, m_, l = ops.paged_attention_kernel(
                q, *pools[0], tb, nt, granularity=gran, frame_pages=fp,
                scale=scale)
            o_r, m_r, l_r = ref.paged_attention_ref(
                q, *pools[0], tb, nt, scale=scale, frame_pages=fpk)
            torch.cuda.synchronize()
            on = o / torch.clamp(l[..., None], min=1e-30)
            on_r = o_r / torch.clamp(l_r[..., None], min=1e-30)
            torch.testing.assert_close(on, on_r, **ATTN_TOL)
            torch.testing.assert_close(m_, m_r, **ML_TOL)
            torch.testing.assert_close(l, l_r, **ML_TOL)
            require(bool(torch.isfinite(on).all()), f"{name}: non-finite")
            if B == MAX_BATCH:
                require(bool((m_[-1] == -1e30).all() and (l[-1] == 0).all()
                             and (o[-1] == 0).all()),
                        f"{name}: all-hole row must give m=-1e30, l=0, o=0")
            errs.append(float((on - on_r).abs().max()))
            layers = [(q, pk, pv, tb, nt) for pk, pv in pools]
            kw = dict(scale=scale)
            tokens = int(nt.sum())
            times[B] = (graph_ms(cycling(functools.partial(
                ops.paged_attention_kernel, granularity=gran,
                frame_pages=fp, **kw), layers)), tokens)
            if B == MAX_BATCH:
                nbytes = (tokens * (dk + dv) * 2 + q.numel() * 2
                          + 2 * tb.numel() * 4 + B * H * (dv + 2) * 4)
                b_ms, b_by = bound_ms(nbytes, 2 * H * (dk + dv) * tokens)
                results[name] = dict(
                    ms=times[B][0],
                    plain_ms=eager_ms(cycling(functools.partial(
                        ref.paged_attention_ref, frame_pages=fpk, **kw),
                        layers)),
                    bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    shape=f"B={B} H={H} n_kv=1 dh={dk} dh_v={dv} "
                          f"blocks={n_blocks} tokens={tokens}")
        r = results[name]
        r["max_abs_err"] = max(errs)
        ns = pa.split_count(n_blocks, tpb)
        print(f"[kernel] {name}: max_abs_err {max(errs):.3g} | kernel_ms "
              f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
              f"{r['bound_ms']:.5f} ({r['bound_by']}) library_ms none (no "
              f"single PyTorch call computes paged attention) | "
              f"{r['shape']} | splits {ns} of {pa.SPLIT_TOKENS} positions, "
              f"grid {ns}x1x{MAX_BATCH} (16 heads a CTA, mma.sync) + "
              f"combine | B=1 ({times[1][1]} tokens): kernel_ms "
              f"{times[1][0]:.4f}")

    name = "flash_attention.mla"
    T, P = FLASH_T, FLASH_P
    q, k, v = randn(1, T, H, dq), randn(1, T, H, dq), randn(1, T, H, 128)
    qs = q[:, P:].contiguous()
    kw = dict(scale=scale)
    full = ops.flash_attention(q, k, v, **kw)
    suffix = ops.flash_attention(qs, k, v, q_offset=P, **kw)
    plain_full = ref.flash_attention_ref(q, k, v, causal=True, **kw)
    plain_suffix = ref.flash_attention_ref(qs, k, v, causal=True,
                                           q_offset=P, **kw)
    torch.cuda.synchronize()
    errs = []
    for got, want in ((full, plain_full), (suffix, plain_suffix)):
        torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL)
        require(bool(torch.isfinite(got.float()).all()), f"{name}: "
                f"non-finite")
        errs.append(float((got.float() - want.float()).abs().max()))
    require(torch.equal(suffix, full[:, P:]), f"{name}: suffix rows are not "
            f"the full call's bit for bit")
    dvh = v.shape[-1]
    pairs = T * (T + 1) // 2
    b_ms, b_by = bound_ms(2 * T * H * (2 * dq + 2 * dvh),
                          2 * H * (dq + dvh) * pairs)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              scale=scale)
    try:                  # a yardstick only: the port never calls it
        sdpa()
        torch.cuda.synchronize()
        lib_ms, lib_note = -1.0, "scaled_dot_product_attention"
    except RuntimeError as exc:
        lib_ms, lib_note = None, f"none (SDPA refused: {str(exc)[:80]})"
    if lib_ms is not None:
        lib_ms = graph_ms(sdpa)
    results[name] = dict(
        max_abs_err=max(errs),
        ms=graph_ms(lambda: ops.flash_attention(q, k, v, **kw)),
        plain_ms=eager_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=True, **kw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        shape=f"B=1 H={H} n_kv={H} dh={dq} dh_v={dvh} T={T} causal")
    r = results[name]
    s_ms = graph_ms(lambda: ops.flash_attention(qs, k, v, q_offset=P, **kw))
    lib = "none" if lib_ms is None else f"{lib_ms:.4f}"
    print(f"[kernel] {name}: max_abs_err {r['max_abs_err']:.3g}, suffix "
          f"rows bitwise == full | (a) full: kernel_ms {r['ms']:.4f} "
          f"plain_ms {r['plain_ms']:.4f} bound_ms {r['bound_ms']:.5f} "
          f"({r['bound_by']}) library_ms {lib} ({lib_note}) | (b) suffix "
          f"Tq={T - P} q_offset={P}: kernel_ms {s_ms:.4f} | {r['shape']} | "
          f"{flash_tiles(H, H, T)}")
    check_copies(kall, rng, randn, "deepseek latent K")
    check_copies(vall, rng, randn, "deepseek latent V")


def flash_entry(results, name, B, Tq, Tk, H, n_kv, dh, causal, randn,
                n_sets=1, what="", dh_v=None):
    """Flash attention at one shape of the path (q [B, Tq, H, dh] over k
    [B, Tk, n_kv, dh] and v [B, Tk, n_kv, dh_v] (default dh), bf16; causal
    calls have Tq == Tk) against its plain
    version, with queries drawn at PEAK_Q times the unit scale so that each
    row's output is O(1) and ATTN_TOL judges it, timed beside its bound and
    beside
    ``scaled_dot_product_attention`` at the same shape (a yardstick: the
    port never calls it).  ``n_sets`` > 1 cycles the timed calls over that
    many K/V sets (decode's cross-attention reads every decoder layer's
    cross K/V in turn, beyond the 50 MB L2).  Stores ``name`` in
    ``results``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    dh_v = dh_v or dh
    q = randn(B, Tq, H, dh) * PEAK_Q
    kvs = [(randn(B, Tk, n_kv, dh), randn(B, Tk, n_kv, dh_v))
           for _ in range(n_sets)]
    k, v = kvs[0]
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL)
    require(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
    pairs = Tq * (Tq + 1) // 2 if causal else Tq * Tk
    b_ms, b_by = bound_ms(2 * (B * Tq * H + B * Tk * n_kv) * (dh + dh_v),
                          2 * B * H * (dh + dh_v) * pairs)
    qt = q.transpose(1, 2).contiguous()
    kvt = [tuple(x.transpose(1, 2).contiguous() for x in kv) for kv in kvs]
    results[name] = dict(
        max_abs_err=float((got.float() - want.float()).abs().max()),
        ms=graph_ms(cycling(functools.partial(ops.flash_attention,
                                              causal=causal),
                            [(q, *kv) for kv in kvs])),
        plain_ms=eager_ms(cycling(functools.partial(
            ref.flash_attention_ref, causal=causal),
            [(q, *kv) for kv in kvs])),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(cycling(functools.partial(
            F.scaled_dot_product_attention, is_causal=causal,
            enable_gqa=True), [(qt, *kv) for kv in kvt])),
        shape=f"B={B} Tq={Tq} Tk={Tk} H={H} n_kv={n_kv} dh={dh} "
              f"{f'dh_v={dh_v} ' if dh_v != dh else ''}"
              f"{'causal' if causal else 'non-causal'}")
    r = results[name]
    g = H // n_kv
    print(f"[kernel] {name} ({what}): max_abs_err {r['max_abs_err']:.3g} "
          f"(output scale {float(want.float().abs().max()):.3g}) | "
          f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
          f"{r['bound_ms']:.5f} ({r['bound_by']}) library_ms "
          f"{r['library_ms']:.4f} (scaled_dot_product_attention) | "
          f"{r['shape']} | tiles 64 rows ({g} heads x {64 // g} positions) x "
          f"64 keys, grid {-(-Tq // (64 // g))}x{n_kv}x{B}"
          f"{f', cycling {n_sets} K/V sets' if n_sets > 1 else ''}")


def time_copies(pool, rng, label):
    """page_gather, page_scatter and page_compact on the stacked pool
    ``pool`` [L, NP, ...], timed cycling over disjoint page sets that cover
    the pool (13 pages with a hole; 4 copies with a hole on each side)
    beside their bounds; printed."""
    import torch
    from repro_torch.kernels import ops
    L, NP = pool.shape[:2]
    dev = pool.device
    page = pool[0, 0].numel() * pool.element_size()
    perm = rng.permutation(NP).astype(np.int32)
    sets = [perm[i * 13:(i + 1) * 13].copy() for i in range(NP // 13)]
    for s_ in sets:
        s_[3] = -1
    sets = [torch.from_numpy(s_).to(dev) for s_ in sets]
    pages = pool[:, :13].clone()
    plans = []
    for i in range(NP // 8):
        c = perm[i * 8:(i + 1) * 8].copy()
        src, dst = c[:4].copy(), c[4:].copy()
        src[1] = dst[2] = -1
        plans.append(tuple(torch.from_numpy(a).to(dev) for a in (src, dst)))
    a = pool.clone()
    parts = []
    for name, fn, args, n_valid in (
            ("page_gather", ops.page_gather, [(pool, i) for i in sets], 12),
            ("page_scatter", ops.page_scatter, [(a, i, pages) for i in sets],
             12),
            ("page_compact", ops.page_compact, [(a, s_, d_)
                                                for s_, d_ in plans], 2)):
        b_ms, _ = bound_ms(2 * L * n_valid * page)
        parts.append(f"{name} kernel_ms {graph_ms(cycling(fn, args)):.4f} "
                     f"bound_ms {b_ms:.5f}")
    print(f"[kernel] page copies ({label}, L={L} page={page}B): "
          f"{' | '.join(parts)} (bytes)")


def phase_family_kernels(results):
    """Phase 3 at the shapes of phases 4g-4i (see the module doc): flash
    attention for seamless's encoder (e), its cross-attention at prefill
    (x) and at decode (d), llava's prefill over the image and the prompt
    (v) and phi3's prefill (p); paged attention at g = 4 / dh 128 (llama3,
    qwen3, llava) and g = 1 / dh 96 (phi3); fused gather-attend at llava's
    g = 4 / dh 128 and seamless's g = 1 / dh 64 (its two fused paths); the
    page copies at phi3's 393,216-byte page.  Entries ``<kernel>.<tag>`` of
    the kernels line."""
    import torch
    from repro_torch.configs import get_config
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    rng = np.random.default_rng(6)

    def randn(*shape):
        return torch.randn(shape, generator=gen,
                           device=dev).to(torch.bfloat16)
    sm = get_config(ENCDEC_ARCH)
    S, Ld = sm.encdec.source_len, sm.encdec.dec_layers
    H, dh = sm.n_heads, sm.resolved_head_dim
    flash_entry(results, "flash_attention.encoder", 1, S, S, H,
                sm.n_kv_heads, dh, False, randn, what="seamless encoder")
    flash_entry(results, "flash_attention.cross_prefill", 1, FLASH_T, S, H,
                sm.n_kv_heads, dh, False, randn,
                what="seamless cross-attention at prefill")
    flash_entry(results, "flash_attention.cross_decode", MAX_BATCH, 1, S, H,
                sm.n_kv_heads, dh, False, randn, n_sets=Ld,
                what="seamless cross-attention at decode")
    lv = get_config(VLM_ARCH)
    T = lv.frontend_tokens + FLASH_T
    flash_entry(results, "flash_attention.vlm", 1, T, T, lv.n_heads,
                lv.n_kv_heads, lv.resolved_head_dim, True, randn,
                what="llava prefill, image + prompt")
    ph = get_config("phi3-mini-3.8b")
    flash_entry(results, "flash_attention.phi3", 1, FLASH_T, FLASH_T,
                ph.n_heads, ph.n_kv_heads, ph.resolved_head_dim, True, randn,
                what="phi3 prefill")
    paged_entries(results, lv.n_heads, lv.n_kv_heads, lv.resolved_head_dim,
                  lv.n_layers, ".g4d128", rng, randn)
    paged_entries(results, ph.n_heads, ph.n_kv_heads, ph.resolved_head_dim,
                  ph.n_layers, ".g1d96", rng, randn, grans=("page",))
    fused_entry(results, lv.n_heads, lv.n_kv_heads, lv.resolved_head_dim,
                lv.n_layers, ".g4d128", rng, randn, max_seq=VLM_MAX_SEQ)
    fused_entry(results, H, sm.n_kv_heads, dh, Ld, ".g1d64", rng, randn)
    pool = randn(ph.n_layers, 80, 64, ph.n_kv_heads, ph.resolved_head_dim)
    check_copies(pool, rng, randn, "phi3-mini-3.8b")
    time_copies(pool, rng, "phi3-mini-3.8b")
    del pool
    torch.cuda.empty_cache()


def ssd_bound(B, T, nh, hd, N, Q, with_h0, G):
    """Bytes (x in bf16 and B, C at their G groups in bf16, dt and A in f32
    read once; y and the final state in f32 written once; h0 read once)
    and operations (C B^T and the scores times dt x over each chunk's
    causal pairs, the carried term and the state update) of one SSD-scan
    call."""
    nbytes = (2 * B * T * (nh * hd + 2 * G * N) + 4 * B * T * nh + 4 * nh
              + 4 * B * T * nh * hd + 4 * B * nh * hd * N * (1 + with_h0))
    pairs = Q * (Q + 1) // 2 * (T // Q)
    flops = B * nh * (2 * pairs * (N + hd) + 4 * T * N * hd)
    return bound_ms(nbytes, flops)


def phase_ssd_kernel(results):
    """The SSD scan against its plain version at the prefill shapes of the
    recurrent families' main paths (``repro_torch.launch.ssd_phases.cases``):
    (a') zamba2-1.2b with its one B/C group, the main path's call, timed
    with its plain version for the kernels line; (a) the same head-expanded
    (G = 64, the first port's interface); (b) mamba2-1.3b (N = 128, one
    group); (c) zamba2 with an initial state carried in over 192-row
    chunks.  Each is timed beside its bound."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.ssd_phases import cases as ssd_cases
    name = "ssd_scan"
    cases = ssd_cases(torch.device("cuda"))
    errs, times = {}, {}
    for key, (args, kw, shape) in cases.items():
        y, h = ops.ssd_scan(*args, **kw)
        y_r, h_r = ref.ssd_scan_ref(*args, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, y_r, **SSD_TOL)
        torch.testing.assert_close(h, h_r, **SSD_TOL)
        require(bool(torch.isfinite(y).all() and torch.isfinite(h).all()),
                f"{name} ({key}): non-finite")
        errs[key] = max(float((y - y_r).abs().max()),
                        float((h - h_r).abs().max()))
        times[key] = graph_ms(lambda: ops.ssd_scan(*args, **kw))
    args, kw, shape = cases["a'"]
    b_ms, b_by = ssd_bound(*shape)
    results[name] = dict(
        max_abs_err=max(errs.values()), ms=times["a'"],
        plain_ms=eager_ms(lambda: ref.ssd_scan_ref(*args, **kw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape="B={} T={} nh={} hd={} N={} Q={} h0={} G={} bf16".format(
            *shape))
    r = results[name]
    err_a = errs["a'"]
    rest = " | ".join(
        f"({key}) {cases[key][2]}: kernel_ms {times[key]:.4f} bound_ms "
        f"{ssd_bound(*cases[key][2])[0]:.5f} max_abs_err {errs[key]:.3g}"
        for key in ("a", "b", "c"))
    print(f"[kernel] {name}: (a') zamba2 prefill, grouped: max_abs_err "
          f"{err_a:.3g} | kernel_ms {r['ms']:.4f} plain_ms "
          f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.5f} "
          f"({r['bound_by']}) library_ms none (no "
          f"single PyTorch call computes an SSD scan) | {r['shape']} | "
          f"{rest} (B, T, nh, hd, N, Q, h0, G)")


def read_counts():
    """Every kernel's launch count and the flash kernel's by call site
    (``flash_attention.<site>``), as the wrappers counted them."""
    from repro_torch.kernels import ops
    return {**ops.launch_counts(), **ops.flash_site_counts()}


def serve_mode(cfg, mode, params=None, device=None, max_seq=MAX_SEQ):
    """One main-path run: the stream served in ``mode`` with the step
    hook, launch counters reset just before and read just after.
    Returns (engine, stream, events, launch counts, wall seconds)."""
    import torch
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, geometry=PoolGeometry(), max_batch=MAX_BATCH,
                        max_seq=max_seq, manager_kind="mosaic",
                        oversubscription=OVERSUB, fault_mode=mode, seed=0,
                        params=params, device=device)
    stream = make_stream(cfg.vocab_size)
    events = MainPathEvents(cfg)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    drive(eng, stream, events)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, stream, events, read_counts(), wall


def check_mode_run(cfg, mode, eng, stream, events, counts):
    """What every main-path run must show, on the card or (counts all 0)
    rehearsed on the CPU."""
    s = eng.stats
    require(all(r.done for _, r in stream), f"{mode}: not every request "
            f"completed")
    for _, r in stream:
        require(len(r.out) == r.max_new
                and all(0 <= tok < cfg.vocab_size for tok in r.out),
                f"{mode}: request {r.rid}: bad output {r.out[:8]}...")
    require(s.swaps_out >= 1 and s.faults >= 1 and s.compaction_copies >= 1,
            f"{mode}: paging not exercised: swaps {s.swaps_out} faults "
            f"{s.faults} CAC copies {s.compaction_copies}")
    require(events.cac_checked, f"{mode}: CAC coherence not checked")
    require(events.probe_frames >= 1, f"{mode}: no coalesced frame in the "
            f"probe")
    n_prefix = cfg.frontend_tokens if cfg.family == "vlm" else 0
    require(events.first_len == n_prefix + len(stream[0][1].prompt) + 1,
            f"{mode}: request 0 holds {events.first_len} pool tokens after "
            f"its first decode step, not its {n_prefix} frontend tokens + "
            f"its prompt + 1")
    require(s.h2d_bytes == s.faults * eng.page_bytes,
            f"{mode}: {s.h2d_bytes} B copied to the card for {s.faults} "
            f"faulted pages of {eng.page_bytes} B")
    if mode == "sync":
        require(s.fault_steps <= s.landings <= s.xfer_chunks,
                "sync: every fault batch lands, a chunk of the page ring at "
                "a time")
    if mode == "async":
        require(s.prefetch_hits > 0, "async: the stream made no prefetch "
                "hit")
    if mode == "fused":
        require(s.fused_steps > 0
                and s.fused_ready_pages + s.fused_drained_pages > 0,
                "fused: no decode step read a staged page")
    check_prefix_state(cfg, mode, eng, stream)
    if eng.device.type != "cuda":
        return
    path = [k for k in counts if k != "ssd_scan" and (
        k != "paged_attention.fused" or mode == "fused") and (
        cfg.family == "encdec" or not k.startswith("flash_attention."))]
    require(all(counts[k] > 0 for k in path),
            f"{mode}: a kernel of the path never launched: {counts}")
    check_launches(cfg, mode, s, counts, probes=1)


def check_prefix_state(cfg, label, eng, stream):
    """The dense family's prefix cache misses (the stream shares no
    prefix) and parks every completion; the moe family has none (as the
    reference: MoE capacity and MLA latents do not replay bitwise)."""
    s = eng.stats
    if cfg.family == "dense":
        require(s.prefix_misses == len(stream) and s.prefix_parked_pages > 0,
                f"{label}: the prefix cache did not miss and park as "
                f"expected ({s.prefix_misses} misses, "
                f"{s.prefix_parked_pages} parked)")
    else:
        require(eng.prefix is None and not eng.prefix_supported
                and s.prefix_hits == s.prefix_parked_pages == 0,
                f"{label}: the {cfg.family} family must not use the prefix "
                f"cache ({s.prefix_hits} hits, {s.prefix_parked_pages} "
                f"parked)")


def path_launches(cfg):
    """Launches of one prefill and of one decode step of ``cfg``: (flash
    attentions and SSD scans per prefill, paged (or fused) attentions and
    flash attentions per decode step).  Dense, vlm and moe stacks: one
    flash per layer at prefill, one paged per layer at decode; hybrid: its
    shared-block invocations and its Mamba-2 layers; ssm: its layers'
    scans; encdec: the encoder's layers plus the decoder's self- and
    cross-attention at prefill, and per decode step the decoder's paged
    self-attention and flash cross-attention."""
    from repro_torch.models.hybrid import n_invocations
    if cfg.family == "ssm":
        return 0, cfg.n_layers, 0, 0
    if cfg.family == "hybrid":
        return n_invocations(cfg), cfg.n_layers, n_invocations(cfg), 0
    if cfg.family == "encdec":
        e = cfg.encdec
        return e.enc_layers + 2 * e.dec_layers, 0, e.dec_layers, e.dec_layers
    return cfg.n_layers, 0, cfg.n_layers, 0


def site_launches(cfg, admissions, steps):
    """The flash kernel's launches by call site over ``admissions``
    prefills and ``steps`` decode steps: encdec's encoder layers and its
    cross-attention layers at prefill and at each decode step; none for
    the other families."""
    enc = dec = 0
    if cfg.family == "encdec":
        enc, dec = cfg.encdec.enc_layers, cfg.encdec.dec_layers
    return {"flash_attention.encoder": enc * admissions,
            "flash_attention.cross_prefill": dec * admissions,
            "flash_attention.cross_decode": dec * steps}


def check_launches(cfg, label, s, counts, probes=0):
    """Every prefill attention (full or suffix) ran the flash kernel and
    every prefill Mamba-2 layer the SSD scan, every decode self-attention a
    paged kernel (the fused one on steps that read staged pages;
    ``probes``: extra page-kernel calls of the dual probe) and every decode
    cross-attention the flash kernel, every landed chunk the scatter and
    every gathered chunk of an eviction or park the gather, each for the K
    and V pools; the flash launches of each encdec call site as
    ``site_launches``."""
    f_pre, ssd_pre, p_step, f_step = path_launches(cfg)
    admissions = s.admit_colds + s.admit_hits
    sites = site_launches(cfg, admissions, s.decode_steps)
    require(all(counts[k] == n for k, n in sites.items())
            and counts["flash_attention"]
            == f_pre * admissions + f_step * s.decode_steps
            and counts["ssd_scan"] == ssd_pre * admissions
            and counts["paged_attention.page"]
            == p_step * (s.decode_steps - s.fused_steps) + probes
            and counts["paged_attention.fused"] == p_step * s.fused_steps
            and counts["page_scatter"] == 2 * s.landings
            and counts["page_gather"] == 2 * s.gathers,
            f"{label}: launches {counts} do not account for "
            f"{s.admit_colds} + {s.admit_hits} prefills (cold + suffix), "
            f"{s.decode_steps} decode steps ({s.fused_steps} fused), "
            f"{s.landings} landings, {s.gathers} gathers ({s.swaps_out} "
            f"evictions, {s.prefix_parked_pages} pages parked)")


def phase_main_path(cfg, modes=MODES, tag="engine", max_seq=MAX_SEQ):
    """Full-width serving runs in each fault mode of ``modes`` on the same
    weights; returns (launch counts summed over the runs, the weights)."""
    import torch
    params = None
    tokens, total = {}, {}
    for mode in modes:
        t0 = time.perf_counter()
        eng, stream, events, counts, wall = serve_mode(cfg, mode, params,
                                                       max_seq=max_seq)
        if params is None:
            n_par = sum(p.numel() for p in eng.lm.parameters())
            print(f"[{tag}] built {describe(cfg, n_par)}; max_seq "
                  f"{max_seq}, pool {eng.cache.pages_per_shard} pages x "
                  f"{eng.page_bytes} B")
            params = dict(eng.lm.state_dict())
        check_mode_run(cfg, mode, eng, stream, events, counts)
        tokens[mode] = {r.rid: list(r.out) for _, r in stream}
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        s = eng.stats
        print(f"[{tag}:{mode}] {s.summary()}")
        print(f"[{tag}:{mode}] measured ({SMI}): wall {wall:.2f}s (with "
              f"build {time.perf_counter() - t0:.2f}s) | decode "
              f"{s.decode_tokens} "
              f"tok in {s.decode_steps} steps: "
              f"{s.decode_tokens / s.decode_s:.1f} tok/s, "
              f"{s.decode_s / s.decode_steps * 1e3:.2f} ms/step | prefill "
              f"{s.prefill_tokens} tok: "
              f"{s.prefill_s / s.prefill_tokens * 1e3:.3f} ms/token | PCIe "
              f"out {s.d2h_bytes} B in {s.d2h_s:.4f}s, in {s.h2d_bytes} B "
              f"in {s.h2d_s:.4f}s | {s.fused_steps} fused steps | dual "
              f"probe {events.probe_frames} frames, max_abs_err "
              f"{events.probe_err:.3g}")
        print(f"[{tag}:{mode}] modeled (link model, clock = measured "
              f"decode): faults {s.faults} in {s.fault_dmas} DMAs, "
              f"transfer {s.transfer_us:.1f}us, hidden "
              f"{s.fault_hidden_us:.1f}us, exposed {s.fault_exposed_us:.1f}"
              f"us, prefetch hit/miss/wasted {s.prefetch_hits}/"
              f"{s.prefetch_misses}/{s.prefetch_wasted}, out (evict + "
              f"park) {s.evict_pages} pages {s.evict_us:.1f}us, fused ready/"
              f"drained {s.fused_ready_pages}/{s.fused_drained_pages}, "
              f"tail {s.fused_tail_us:.1f}us")
        print(f"[{tag}:{mode}] launches: {json.dumps(counts)}")
        del eng
        torch.cuda.empty_cache()
    diff = [m for m in modes if tokens[m] != tokens["sync"]]
    require(not diff, f"{tag}: tokens differ from sync in {diff}")
    print(f"[{tag}] {' == '.join(modes)} on every greedy token")
    return total, params


class ExpertChoices:
    """One device's MoE expert choices replayed on another, through the
    ``moe.top_k`` hook.  A router near-tie that two devices break apart
    would move that token's output far beyond any rounding, so the second
    run takes the first's choices, and ``share()`` counts the tokens whose
    own choice was the same.  The two runs must call the router in the
    same order (the same model, inputs and steps)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.top_k = moe, moe.top_k
        self.choices, self.same = [], []

    def record(self, probs, k):
        vals, idx = self.top_k(probs, k)
        self.choices.append(idx)
        return vals, idx

    def replay(self, probs, k):
        import torch
        require(len(self.same) < len(self.choices), "expert replay: the "
                "second run routes more often than the first")
        idx = self.choices[len(self.same)].to(probs.device)
        own = self.top_k(probs, k)[1]
        self.same.append((own.sort(-1).values == idx.sort(-1).values)
                         .all(-1).reshape(-1))
        return torch.gather(probs, -1, idx), idx

    def run(self, hook, fn, *args, **kw):
        """``fn(*args, **kw)`` with ``moe.top_k`` replaced by ``hook``."""
        self.moe.top_k = hook
        try:
            return fn(*args, **kw)
        finally:
            self.moe.top_k = self.top_k

    def share(self):
        """(share of tokens routed alike, tokens routed); every recorded
        choice must have been replayed."""
        import torch
        require(len(self.same) == len(self.choices), f"expert replay: "
                f"{len(self.choices)} router calls recorded, "
                f"{len(self.same)} replayed")
        if not self.same:
            return 1.0, 0
        same = torch.cat(self.same)
        return float(same.float().mean()), len(same)


def lm_agreement(cfg, dev, ref_dev="cpu", ref_dtype=None):
    """``cfg``'s LM on ``dev`` (the kernels, on the card) against the same
    weights on ``ref_dev`` (the plain versions, on the CPU; in
    ``ref_dtype`` where given, so that a long prefill stays quick there):
    prefill of a 100-token prompt padded to two 64-token pages, then two
    decode steps.  vlm prefills random image embeddings (``patch_embeds``,
    from a seed) in front of the prompt, encdec encodes random source
    frames (``src_embeds``): the engine's zero stubs would leave the
    cross-attention nothing to hold.  The reference run takes ``dev``'s
    expert choices (``moe.top_k`` replays them): a router near-tie that
    the two devices break apart would move that token's output far beyond
    any rounding, so the choices are counted instead and at least 90 % of
    the tokens must get the same experts from both.  Logits, both pools
    (MLA: the latent pools) and the decode state (encdec: cross K/V) must
    agree to 2e-2 of their scale, as the bf16 MoE block's card test.
    Returns (share of tokens with the same experts, tokens routed, the
    largest error relative to its scale)."""
    import torch
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.models.lm import LM
    from repro_torch.serving.kv_cache import ShardedKVCache
    lm = LM(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(0))
    ref_cfg = cfg if ref_dtype is None else dataclasses.replace(
        cfg, dtype=ref_dtype)
    ref_lm = LM(ref_cfg, device=ref_dev)
    ref_lm.load_state_dict({k: v.to(ref_dev)
                            for k, v in lm.state_dict().items()})
    geo = PoolGeometry()
    ptok, fp, T = geo.page_tokens, geo.frame_pages, 100
    n_prefix = cfg.frontend_tokens if cfg.family == "vlm" else 0
    mpps = max(4, -(-(n_prefix + 2 * ptok) // ptok))
    NP = max(2, -(-mpps // fp)) * fp
    rng = np.random.default_rng(9)
    toks = np.zeros((1, 2 * ptok), np.int32)
    toks[0, :T] = rng.integers(0, cfg.vocab_size, T)
    new = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (1, n_prefix, cfg.d_model), dtype=np.float32)
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.standard_normal(
            (1, cfg.encdec.source_len, cfg.d_model), dtype=np.float32)
    experts = ExpertChoices()

    def serve(d, model):
        cache = ShardedKVCache(geo, NP, 1)
        cache.allocate(0, n_prefix + T)
        pools = tuple(torch.zeros(sh, dtype=dt, device=d) for sh, dt in
                      model.pool_shapes(NP, ptok, dtype=getattr(
                          torch, model.cfg.dtype)))
        logits, pools, state = model.prefill(
            {k: torch.from_numpy(v).to(d) for k, v in batch.items()},
            pools, cache.pack_ctx([0], mpps, device=d),
            last_pos=torch.tensor([T - 1], device=d))
        out = [logits]
        for i in range(2):
            cache.append(0)
            logits, pools, state = model.decode_step(
                torch.from_numpy(new[i:i + 1]).to(d),
                torch.tensor([n_prefix + T + i], device=d), pools,
                cache.pack_ctx([0], mpps, device=d), state)
            out.append(logits)
        return out, pools, [state[k] for k in sorted(state)]
    runs = [experts.run(hook, serve, d, model)
            for d, model, hook in ((dev, lm, experts.record),
                                   (ref_dev, ref_lm, experts.replay))]
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    agree, n_routed = experts.share()
    require(agree >= 0.9, f"agreement: the two devices route only "
            f"{agree:.1%} of the tokens to the same experts")
    errs = []
    for what, got, want in (
            [(f"logits {i}", a, b)
             for i, (a, b) in enumerate(zip(runs[0][0], runs[1][0]))]
            + [(f"pool {i}", a, b)
               for i, (a, b) in enumerate(zip(runs[0][1], runs[1][1]))]
            + [(f"state {i}", a, b)
               for i, (a, b) in enumerate(zip(runs[0][2], runs[1][2]))]):
        got, want = got.to(ref_dev).float(), want.float()
        require(bool(torch.isfinite(got).all()) and got.shape == want.shape,
                f"agreement: {what}: non-finite or shape {got.shape}")
        err, scale = (float((got - want).abs().max()),
                      float(want.abs().max()))
        require(err <= 2e-2 * scale, f"agreement: {what}: max_abs_err "
                f"{err:.3g} beyond 2e-2 of its scale {scale:.3g}")
        errs.append(err / scale)
    layers = (f"{cfg.encdec.enc_layers} + {cfg.encdec.dec_layers} layers"
              if cfg.family == "encdec" else f"{cfg.n_layers} layers")
    print(f"[agreement] {cfg.name} ({layers}, d_model {cfg.d_model}, "
          f"{cfg.dtype}) on {dev} vs the plain versions on {ref_dev} "
          f"({ref_cfg.dtype}): prefill of {n_prefix} image + {T} prompt "
          f"tokens, 2 decode steps: logits, pools"
          f"{' and cross K/V' if runs[0][2] else ''} within {max(errs):.3g} "
          f"of their scale; same experts for {agree:.1%} of "
          f"{n_routed} routed tokens")
    return agree, n_routed, max(errs)


def check_agreement(cut, ref_dtype=None):
    """``lm_agreement`` of ``cut`` on the card, with its launches: one
    prefill and two decode steps of ``path_launches``."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    lm_agreement(cut, "cuda", ref_dtype=ref_dtype)
    n = read_counts()
    f_pre, _, p_step, f_step = path_launches(cut)
    sites = site_launches(cut, 1, 2)
    require(n["flash_attention"] == f_pre + 2 * f_step
            and n["paged_attention.page"] == 2 * p_step
            and all(n[k] == m for k, m in sites.items()),
            f"agreement: launches {n}, not {f_pre} + 2 x {f_step} flash "
            f"({sites} by site) and 2 x {p_step} paged")
    torch.cuda.empty_cache()


def phase_mla_serving():
    """Phase 4e: deepseek-v2-lite at full width cut to 2 layers, on the
    card against the CPU (``lm_agreement``); then at its published width
    and depth (MLA over latent pools, 64-expert MoE after one dense-FFN
    layer) through phase 4's stream and step hook, in sync and async;
    fused is refused, as in the reference.  Returns the summed launch
    counts of the serving runs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config(MLA_ARCH)
    # The whole model at full width, cut to its dense layer and one MoE
    # layer, on the card against the CPU's plain versions.
    check_agreement(dataclasses.replace(cfg, n_layers=2))
    try:
        ServingEngine(cfg, geometry=PoolGeometry(), max_batch=MAX_BATCH,
                      max_seq=MAX_SEQ, fault_mode="fused")
    except ValueError as exc:
        print(f"[mla] fault_mode='fused' refused: {exc}")
    else:
        raise SmokeFailure("mla: fault_mode='fused' was not refused")
    total, params = phase_main_path(cfg, SSM_MODES, tag="mla")
    del params
    torch.cuda.empty_cache()
    return total


def serve_prefix(cfg, mode, prefix_cache, params=None, device=None):
    """One phase-4b run: the two waves served in ``mode``, the second
    submitted once the first has drained, launch counters reset just
    before and read just after.  Returns (engine, requests, launch counts,
    wall seconds)."""
    import torch
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, geometry=PoolGeometry(), max_batch=MAX_BATCH,
                        max_seq=MAX_SEQ, fault_mode=mode,
                        prefix_cache=prefix_cache, seed=0, params=params,
                        device=device)
    waves = make_prefix_waves(cfg.vocab_size)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for wave in waves:
        for r in wave:
            eng.submit(r)
        eng.run_until_drained(max_steps=400)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, waves[0] + waves[1], read_counts(), wall


def check_prefix_run(cfg, label, eng, reqs, counts):
    """What every phase-4b run must show, on the card or (counts all 0)
    rehearsed on the CPU."""
    s = eng.stats
    require(all(r.done and len(r.out) == r.max_new
                and all(0 <= t < cfg.vocab_size for t in r.out)
                for r in reqs), f"{label}: a request did not complete")
    eng.cache.check_invariants()
    require(s.admit_hits + s.admit_colds == len(reqs),
            f"{label}: {s.admit_hits} + {s.admit_colds} admissions for "
            f"{len(reqs)} requests")
    require(s.h2d_bytes == s.faults * eng.page_bytes,
            f"{label}: {s.h2d_bytes} B copied to the card for {s.faults} "
            f"faulted pages")
    if eng.prefix is not None:
        require(s.prefix_hits >= 4 and s.admit_hits == s.prefix_hits,
                f"{label}: {s.prefix_hits} prefix hits, expected >= 4")
        require(s.faults >= s.prefix_reused_tokens // eng.geo.page_tokens,
                f"{label}: reused pages did not fault in")
        require(s.prefix_h2d_bytes == s.prefix_reused_tokens
                // eng.geo.page_tokens * eng.page_bytes,
                f"{label}: cached prefix uploaded {s.prefix_h2d_bytes} B")
    if eng.device.type != "cuda":
        return
    require(counts["flash_attention"] > 0 and counts["paged_attention.page"]
            > 0 and (eng.prefix is None or counts["page_scatter"] > 0
                     and counts["page_gather"] > 0),
            f"{label}: a kernel of the path never launched: {counts}")
    check_launches(cfg, label, s, counts)


def serve_stream(cfg, mode, n_requests=8, params=None, device=None):
    """One phase-4c/4d/4f run: the first ``n_requests`` of the main path's
    stream served by ``cfg`` (hybrid, ssm or moe) in ``mode`` with phase
    4's pool and no step hook, launch counters reset just before and read
    just after.  Returns (engine, stream, launch counts, wall seconds)."""
    import torch
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, geometry=PoolGeometry(), max_batch=MAX_BATCH,
                        max_seq=MAX_SEQ, manager_kind="mosaic",
                        oversubscription=OVERSUB, fault_mode=mode, seed=0,
                        params=params, device=device)
    stream = make_stream(cfg.vocab_size)[:n_requests]
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    drive(eng, stream)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, stream, read_counts(), wall


def check_stream_run(cfg, label, eng, stream, counts):
    """What every phase-4c/4d/4f run must show, on the card or (counts
    all 0) rehearsed on the CPU."""
    s = eng.stats
    require(all(r.done for _, r in stream), f"{label}: not every request "
            f"completed")
    for _, r in stream:
        require(len(r.out) == r.max_new
                and all(0 <= tok < cfg.vocab_size for tok in r.out),
                f"{label}: request {r.rid}: bad output {r.out[:8]}...")
    require(not eng.states, f"{label}: recurrent state of finished "
            f"requests was kept: {sorted(eng.states)}")
    check_prefix_state(cfg, label, eng, stream)
    if cfg.family == "ssm":
        require(eng.pools is None and s.h2d_bytes == s.d2h_bytes == 0,
                f"{label}: the ssm family moved KV bytes")
    else:
        require(s.h2d_bytes == s.faults * eng.page_bytes,
                f"{label}: {s.h2d_bytes} B copied to the card for "
                f"{s.faults} faulted pages of {eng.page_bytes} B")
    if cfg.family == "hybrid":
        require(s.swaps_out >= 1 and s.faults >= 1,
                f"{label}: paging not exercised: swaps {s.swaps_out} "
                f"faults {s.faults}")
    if eng.device.type != "cuda":
        return
    path = {"ssm": ["ssd_scan"],
            "hybrid": ["ssd_scan", "flash_attention", "paged_attention.page",
                       "page_gather", "page_scatter"],
            "moe": ["flash_attention", "paged_attention.page"],
            "dense": ["flash_attention", "paged_attention.page"]}[cfg.family]
    require(all(counts[k] > 0 for k in path),
            f"{label}: a kernel of the path never launched: {counts}")
    check_launches(cfg, label, s, counts)


def describe(cfg, n_par):
    """The [<tag>] built line's model: published widths, depth (and its
    cut), parameters."""
    from repro_torch.configs import get_config
    full = get_config(cfg.name).n_layers
    depth = (f"{cfg.n_layers} layers" if cfg.n_layers == full else
             f"depth-cut to {cfg.n_layers} of {full} layers")
    if cfg.family == "moe":
        mo = cfg.moe
        body = (f"{mo.n_experts} experts top-{mo.top_k} of {mo.d_expert}"
                f"{f' + {mo.n_shared} shared' if mo.n_shared else ''}")
    elif cfg.family in ("ssm", "hybrid"):
        body = f"Mamba-2, d_state {cfg.ssm.d_state}"
    else:
        body = (f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of "
                f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}"
                f"{', qk-norm' if cfg.qk_norm else ''}")
        if cfg.family == "vlm":
            body += f", {cfg.frontend_tokens} image tokens"
        if cfg.family == "encdec":
            e = cfg.encdec
            depth = (f"{e.enc_layers} encoder + {e.dec_layers} decoder "
                     f"layers")
            body += f", source_len {e.source_len}"
    return (f"{cfg.name} at its published widths ({depth}, d_model "
            f"{cfg.d_model}, {body}, vocab {cfg.vocab_size}, {cfg.dtype}, "
            f"{n_par / 1e9:.3f} G parameters)")


def phase_stream(cfg, modes, n_requests, tag=None):
    """Phases 4c (hybrid), 4d (ssm), 4f (moe) and 4i (dense): ``cfg``
    served in each of ``modes`` on the same weights, with the card's
    memory high-water mark of each run; returns the launch counts summed
    over the runs."""
    import torch
    tag = tag or cfg.family
    params = None
    tokens, total = {}, {}
    for mode in modes:
        torch.cuda.reset_peak_memory_stats()
        eng, stream, counts, wall = serve_stream(cfg, mode, n_requests,
                                                 params)
        if params is None:
            pool = ("no KV pool" if eng.pools is None else
                    f"pool {eng.cache.pages_per_shard} pages x "
                    f"{eng.page_bytes} B")
            n_par = sum(p.numel() for p in eng.lm.parameters())
            print(f"[{tag}] built {describe(cfg, n_par)}; {pool}")
            params = dict(eng.lm.state_dict())
        label = f"{tag}:{mode}"
        check_stream_run(cfg, label, eng, stream, counts)
        tokens[mode] = {r.rid: list(r.out) for _, r in stream}
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        s = eng.stats
        print(f"[{label}] {s.summary()}")
        print(f"[{label}] measured ({SMI}): wall {wall:.2f}s | decode "
              f"{s.decode_tokens} tok in {s.decode_steps} steps: "
              f"{s.decode_s / s.decode_steps * 1e3:.2f} ms/step | prefill "
              f"{s.prefill_tokens} tok in {s.admit_colds} admissions: "
              f"{s.prefill_s / s.prefill_tokens * 1e3:.4f} ms per prompt "
              f"token | PCIe out {s.d2h_bytes} B in {s.d2h_s:.4f}s, in "
              f"{s.h2d_bytes} B in {s.h2d_s:.4f}s | {s.fused_steps} fused "
              f"steps | card memory high-water mark "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        print(f"[{label}] launches: {json.dumps(counts)}")
        del eng
        torch.cuda.empty_cache()
    diff = [m for m in modes if tokens[m] != tokens[modes[0]]]
    require(not diff, f"{tag}: tokens differ from {modes[0]} in {diff}")
    print(f"[{tag}] {' == '.join(modes)} on every greedy token")
    return total


def row_probe(cfg):
    """The reason prefill runs on fixed row blocks (``PREFILL_ROWS``): the
    last 64 rows of a 576-row bf16 product over the FFN's d_ff inputs,
    against the same 64 rows multiplied alone.  Prints whether the library
    gave them the same bits; checks nothing."""
    import torch
    from repro_torch.models.transformer import PREFILL_ROWS
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((576, cfg.d_ff), generator=gen, device="cuda").to(
        torch.bfloat16)
    w = torch.randn((cfg.d_ff, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    whole, alone = (x @ w)[512:], x[512:] @ w
    torch.cuda.synchronize()
    diff = float((whole.float() - alone.float()).abs().max())
    print(f"[prefix] row invariance of a bf16 product over {cfg.d_ff} "
          f"inputs: rows 512..575 of a 576-row product vs the same 64 rows "
          f"alone: bitwise {torch.equal(whole, alone)}, max abs diff "
          f"{diff:.4g} (prefill therefore multiplies fixed "
          f"{PREFILL_ROWS}-row blocks)")


def phase_prefix(cfg, params):
    """Phase 4b: the prefix cache at full width (see the module doc)."""
    import torch
    row_probe(cfg)
    runs = [("sync", True), ("async", True), ("fused", True),
            ("async", False)]
    tokens, stats = {}, {}
    for mode, on in runs:
        label = f"prefix:{mode}:{'on' if on else 'off'}"
        eng, reqs, counts, wall = serve_prefix(cfg, mode, on, params)
        check_prefix_run(cfg, label, eng, reqs, counts)
        s = eng.stats
        tokens[label] = {r.rid: list(r.out) for r in reqs}
        stats[on] = s
        prompt = sum(len(r.prompt) for r in reqs)
        print(f"[{label}] {s.summary()}")
        print(f"[{label}] measured: wall {wall:.2f}s | prefill "
              f"{s.prefill_tokens} of {prompt} prompt tok in "
              f"{s.prefill_s:.3f}s + cached prefix upload "
              f"{s.prefix_h2d_bytes} B in {s.prefix_h2d_s:.4f}s: "
              f"{(s.prefill_s + s.prefix_h2d_s) / prompt * 1e3:.4f} ms per "
              f"prompt token | admissions {s.admit_colds} cold "
              f"{s.admit_cold_mean_us() / 1e3:.1f} ms, {s.admit_hits} hit "
              f"{s.admit_hit_mean_us() / 1e3:.1f} ms mean | decode "
              f"{s.decode_s / s.decode_steps * 1e3:.2f} ms/step")
        print(f"[{label}] launches: {json.dumps(counts)}")
        del eng
        torch.cuda.empty_cache()
    first = next(iter(tokens.values()))
    diff = [k for k, t in tokens.items() if t != first]
    require(not diff, f"prefix cache: tokens differ in {diff}")
    on, off = stats[True], stats[False]
    require(on.prefill_tokens == off.prefill_tokens
            - on.prefix_reused_tokens,
            f"prefix cache: prefill tokens {on.prefill_tokens} (on) != "
            f"{off.prefill_tokens} (off) - {on.prefix_reused_tokens} reused")
    print(f"[prefix] cache on (sync, async, fused) == off on every greedy "
          f"token; {on.prefix_hits} hits reused {on.prefix_reused_tokens} "
          f"tokens: prefill {on.prefill_tokens} vs {off.prefill_tokens} "
          f"tokens")


def narrow_config(cfg_full):
    """Phases 5 and 8d: a narrow f32 model (2 layers, head dim 32, which
    the card's kernels take)."""
    return dataclasses.replace(cfg_full, n_layers=2, d_model=128, n_heads=4,
                               n_kv_heads=2, d_ff=256, vocab_size=512,
                               dtype="float32")


def phase_small_agreement(cfg_full):
    """A narrow model (head_dim 32) on the card vs the same on the CPU."""
    import torch
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.serving.engine import ServingEngine
    cfg = narrow_config(cfg_full)
    outs = {}
    params = None
    for dev in ("cuda", "cpu"):
        eng = ServingEngine(cfg, geometry=PoolGeometry(), max_batch=MAX_BATCH,
                            max_seq=MAX_SEQ, oversubscription=OVERSUB,
                            fault_mode="fused", seed=0, params=params,
                            device=dev)
        if params is None:
            params = {k: v.cpu() for k, v in eng.lm.state_dict().items()}
        stream = make_stream(cfg.vocab_size)
        drive(eng, stream)
        outs[dev] = {r.rid: list(r.out) for _, r in stream}
        if dev == "cuda":
            torch.cuda.synchronize()
    diff = [rid for rid in outs["cpu"] if outs["cpu"][rid] != outs["cuda"][rid]]
    require(not diff, f"small model: card and CPU tokens differ for {diff}")
    print("[small] narrow model, same weights, fused mode: card (kernels) "
          "== CPU (plain versions) on every greedy token")


def phase_transparency(cfg, params):
    """mosaic vs gpu-mmu without oversubscription: same batches, same
    tokens; then a held-preemption round trip on a third engine."""
    import torch
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.serving.engine import ServingEngine
    runs = {}
    for kind in ("mosaic", "gpu-mmu"):
        eng = ServingEngine(cfg, geometry=PoolGeometry(),
                            max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                            manager_kind=kind, params=params)
        stream = make_stream(cfg.vocab_size)
        batches = drive(eng, stream)
        runs[kind] = (batches, {r.rid: list(r.out) for _, r in stream})
        del eng
        torch.cuda.empty_cache()
    require(runs["mosaic"][0] == runs["gpu-mmu"][0],
            "batches differ between managers: tokens not comparable")
    require(runs["mosaic"][1] == runs["gpu-mmu"][1],
            "mosaic and gpu-mmu emitted different tokens")
    print(f"[transparency] mosaic == gpu-mmu: {len(runs['mosaic'][0])} "
          f"identical batches, identical greedy tokens")

    eng = ServingEngine(cfg, geometry=PoolGeometry(), max_batch=MAX_BATCH,
                        max_seq=MAX_SEQ, manager_kind="mosaic", params=params)
    stream = make_stream(cfg.vocab_size)
    for _, r in stream[:6]:
        eng.submit(r)
    for _ in range(5):
        eng.step()
    rid = eng.active[0].rid
    tokens = eng.cache.seq_tokens[rid]
    require(eng.preempt(rid, hold=True), "preempt failed")
    saved = {key: eng.host.peek(*key) for key in eng.host.seq_pages(rid)}
    require(saved, "held request parked no pages")
    require(eng.release(rid), "release failed")
    eng.step()
    require(rid in [r.rid for r in eng.active], "released request not resumed")
    ptok = eng.geo.page_tokens
    pps = eng.cache.pages_per_shard
    for (_, s, vpn), (kp, vp) in saved.items():
        ppn = s * pps + eng.cache.mgrs[s].tables[rid].ppn[vpn]
        n = min(ptok, tokens - vpn * ptok)
        require(torch.equal(eng.pools[0][:, ppn, :n].cpu(), kp[:, :n])
                and torch.equal(eng.pools[1][:, ppn, :n].cpu(), vp[:, :n]),
                f"round trip: page {vpn} of request {rid} differs")
    print(f"[roundtrip] request {rid}: {len(saved)} pages out to host and "
          f"back, bit-identical")


# ---------------------------------------------------------------- cluster


def cluster_requests(vocab: int):
    """Phase 8's traffic: phase 4b's two shared-prefix waves (rids 0-5),
    then phase 4's stream with its rids moved up by ``CLUSTER_RID`` (rids
    are unique cluster-wide).  Returns (wave 1, wave 2, stream)."""
    wave1, wave2 = make_prefix_waves(vocab)
    stream = make_stream(vocab)
    for _, r in stream:
        r.rid += CLUSTER_RID
    return wave1, wave2, stream


def fault_injector(plan):
    """A ``FaultInjector`` running ``plan``, plus one on-disk bit flip in
    the first frame of engine 0's domain (a request frame) that the tier
    writes: its id is known only once the run spills it.  The flipped byte
    comes from the plan's seeded RNG, as for the plan's own
    ``corrupt_frames``; ``tier`` is set once the cluster exists."""
    from repro_torch.serving.faults import FaultInjector

    class RequestFrameCorruption(FaultInjector):
        tier = None

        def corrupt_written(self, frame, blob):
            if (not self.plan.corrupt_frames and self.tier is not None
                    and self.tier.frames._frame_owner.get(frame) == 0):
                self.plan = dataclasses.replace(self.plan,
                                                corrupt_frames=(frame,))
            return super().corrupt_written(frame, blob)

    return RequestFrameCorruption(plan)


class ClusterRun:
    """Runs one ``ServingCluster`` through phase 8 (device-agnostic, also
    run on the CPU).  Each router step is timed on the host clock and
    followed by ``check_invariants()``.  Each work-stealing migration
    snapshots the host payloads the source engine gathered; once the
    request has decoded on the destination, its pages in the destination's
    pool must hold those bytes (as phase 7's round trip).  Promotes from
    the spill tier are timed on the host clock (disk read and checksum)."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.step_s = []
        self.promote_s = 0.0
        self.pending = []     # (rid, dst, payloads, tokens, outputs so far)
        self.landed = []      # (rid, pages) whose landing was checked
        self.stream_start = 0
        self.after_crash = None   # the host tier's leases after a crash
        self.built_bytes = 0      # card memory once the cluster is built
        self.e1_parked_before_wave2 = 0
        self.e1_hits_wave2 = 0
        migrate = cluster.router._migrate
        promote = cluster.tier._promote_frame

        def _migrate(rid, src, dst):
            migrate(rid, src, dst)
            store = cluster.tier.store
            req = next(r for r in dst.preempted if r.rid == rid)
            self.pending = [p for p in self.pending if p[0] != rid]
            self.pending.append((rid, dst, {k: store.peek(*k) for k in
                                            cluster.tier.seq_pages(rid)},
                                 dst._saved_tokens[rid], len(req.out)))

        def _promote_frame(f):
            t0 = time.perf_counter()
            try:
                return promote(f)
            finally:
                self.promote_s += time.perf_counter() - t0

        cluster.router._migrate = _migrate
        cluster.tier._promote_frame = _promote_frame

    def busy(self) -> bool:
        router = self.cluster.router
        return bool(router.pending) or any(router._busy(e)
                                           for e in self.cluster.engines)

    def step(self) -> None:
        from repro_torch.serving.cluster import PREFIX_DOMAIN
        router, frames = self.cluster.router, self.cluster.tier.frames
        crashes = router.stats.crashes
        t0 = time.perf_counter()
        self.cluster.step()
        self.step_s.append(time.perf_counter() - t0)
        self.cluster.check_invariants()
        if router.stats.crashes > crashes:
            dead = [e.engine_id for e in self.cluster.engines if not e.alive]
            self.after_crash = {
                "dead_engine_frames": sum(frames.frames_of(d) for d in dead),
                "prefix_frames": frames.frames_of(PREFIX_DOMAIN),
                "recovered_bundles": router.stats.recovered_bundles}
        self._check_landings()

    def drain(self, max_steps: int = 2000) -> None:
        for _ in range(max_steps):
            if not self.busy():
                break
            self.step()
        require(not self.busy(), f"cluster not drained in {max_steps} steps")
        self.cluster.run_until_drained()    # settles the DMA lanes only

    def _check_landings(self) -> None:
        import torch
        for item in list(self.pending):
            rid, dst, snap, tokens, n_out = item
            if not dst.alive:
                self.pending.remove(item)
                continue
            req = next((r for r in dst.active if r.rid == rid), None)
            if req is None or len(req.out) <= n_out:
                continue
            ptok, pps = dst.geo.page_tokens, dst.cache.pages_per_shard
            for (_o, s, vpn), (kp, vp) in snap.items():
                ppn = s * pps + dst.cache.mgrs[s].tables[rid].ppn[vpn]
                n = min(ptok, tokens - vpn * ptok)
                require(torch.equal(dst.pools[0][:, ppn, :n].cpu(), kp[:, :n])
                        and torch.equal(dst.pools[1][:, ppn, :n].cpu(),
                                        vp[:, :n]),
                        f"migration: page {vpn} of request {rid} landed on "
                        f"engine {dst.engine_id} differs from the payload "
                        f"the source gathered")
            self.landed.append((rid, len(snap)))
            self.pending.remove(item)


def serve_cluster(cfg, device=None, plan=None, weights=None):
    """One phase-8 run: ``CLUSTER_ENGINES`` replicas sharing one LM
    (weights from seed 0), a shared host tier of ``CLUSTER_FRAMES`` frames
    over a disk spill directory, the shared prefix index, migration,
    pre-staging and the radix translation meter, async fault-in, phase 4's
    pool per engine and ``decode_window_us`` = ``CLUSTER_WINDOW_US`` (the
    router's costs come from the modeled clock).  Wave 1 is pinned to
    engine 0; wave 2 is routed once wave 1 has drained; then the stream,
    pinned to engine 0 (it preempts under the priority arrivals while
    engine 1 has room, so engine 1 steals).  ``plan``: a ``FaultPlan``
    run by :func:`fault_injector`.  ``weights``: a state dict loaded into
    the replicas' one LM in place of the seed's.  Launch counters are
    reset just before the traffic and read just after.  Returns (run,
    requests, launch counts, wall seconds)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.kernels import ops
    from repro_torch.serving.cluster import ServingCluster
    inj = None if plan is None else fault_injector(plan)
    spill_dir = tempfile.mkdtemp(prefix="chip-smoke-spill-")
    try:
        cluster = ServingCluster(
            cfg, geometry=PoolGeometry(), n_engines=CLUSTER_ENGINES,
            max_batch=MAX_BATCH, max_seq=MAX_SEQ, manager_kind="mosaic",
            seed=0, share_host=True, share_prefix=True, migrate=True,
            router_prestage=True, capacity_frames=CLUSTER_FRAMES,
            spill_dir=spill_dir, fault_injector=inj,
            oversubscription=OVERSUB, decode_window_us=CLUSTER_WINDOW_US,
            translation="radix", device=device)
        if inj is not None:
            inj.tier = cluster.tier
        if weights is not None:
            cluster.engines[0].lm.load_state_dict(weights)
        run = ClusterRun(cluster)
        if cluster.engines[0].device.type == "cuda":
            # Weights and pools are in place: what the card holds now, and
            # the high-water mark of serving from here on.
            torch.cuda.synchronize()
            run.built_bytes = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        wave1, wave2, stream = cluster_requests(cfg.vocab_size)
        e1 = cluster.engines[1]
        if device is None or torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for r in wave1:
            cluster.submit(r, engine=0)
        run.drain()
        run.e1_parked_before_wave2 = e1.stats.prefix_parked_pages
        for r in wave2:
            cluster.submit(r)
        run.drain()
        run.e1_hits_wave2 = e1.stats.prefix_hits
        run.stream_start = cluster.router._step_no
        pending = sorted(stream, key=lambda a: a[0])
        step = 0
        while pending or run.busy():
            require(step < 2000, "cluster: the stream did not drain")
            while pending and pending[0][0] <= step:
                cluster.submit(pending.pop(0)[1], engine=0)
            run.step()
            step += 1
        run.drain()
        if device is None or torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        cluster.tier.spill_store.close()
    finally:
        shutil.rmtree(spill_dir, ignore_errors=True)
    return run, wave1 + wave2 + [r for _, r in stream], counts, wall


def cluster_signature(run, reqs):
    """What two runs of one phase-8 configuration must reproduce: tokens
    per request, the router's decisions, the frame table's, the tier's and
    the spill store's counters, each engine's translation counters and
    the injector's log."""
    c = run.cluster
    inj = c.fault_injector
    return {
        "tokens": {r.rid: list(r.out) for r in reqs},
        "router": dataclasses.asdict(c.router.stats),
        "frames": dict(c.tier.frames.stats),
        "tier": dict(c.tier.stats),
        "spill": dict(c.tier.spill_store.stats),
        "translation": [(e.stats.translation_lookups,
                         e.stats.translation_tlb_hits,
                         e.stats.translation_walks,
                         e.stats.translation_walk_cycles,
                         e.stats.translation_queue_cycles,
                         e.stats.translation_us) for e in c.engines],
        "injector": None if inj is None else list(inj.log),
    }


def check_cluster_run(cfg, label, run, reqs, counts, faulted=False):
    """What every phase-8 run must show, on the card or (counts all 0)
    rehearsed on the CPU: 8a's gates, or 8b's with ``faulted``."""
    c = run.cluster
    r, tier, ts = c.router.stats, c.tier, c.tier.stats
    t = c.stats().totals
    for q in reqs:
        require(q.done and len(q.out) == q.max_new
                and all(0 <= tok < cfg.vocab_size for tok in q.out),
                f"{label}: request {q.rid} did not complete its "
                f"{q.max_new} tokens")
    require(all(e.lm is c.engines[0].lm for e in c.engines),
            f"{label}: the replicas do not share one LM")
    require(all(r.dispatched.get(i, 0) > 0 for i in range(len(c.engines))),
            f"{label}: not every engine was dispatched to: {r.dispatched}")
    require(all(e.stats.translation_lookups > 0 for e in c.engines),
            f"{label}: an engine's translation meter saw no lookup")
    require(ts["spilled_frames"] >= 1 and (
        faulted or ts["promoted_frames"] >= 1),
            f"{label}: {ts['spilled_frames']} frames spilled, "
            f"{ts['promoted_frames']} promoted back")
    require(run.e1_parked_before_wave2 == 0 and run.e1_hits_wave2 >= 1
            and c.engines[1].stats.landings >= 1,
            f"{label}: engine 1 parked {run.e1_parked_before_wave2} pages "
            f"before wave 2 and hit the shared index {run.e1_hits_wave2} "
            f"times in it: no cross-engine prefix reuse")
    admissions = t.admit_colds + t.admit_hits
    if not faulted:
        require(r.migrations >= 1 and r.migrated_pages > 0
                and tier.frames.stats["whole_frame_moves"] >= 1,
                f"{label}: {r.migrations} migrations ({r.migrated_pages} "
                f"pages, {tier.frames.stats['whole_frame_moves']} "
                f"whole-frame owner flips)")
        require(run.landed and not run.pending,
                f"{label}: migrated pages not checked on the destination: "
                f"{[p[0] for p in run.pending]}")
        require(admissions == len(reqs) and t.lost_restarts == 0,
                f"{label}: {admissions} admissions for {len(reqs)} "
                f"requests: a migration re-prefilled")
    else:
        dead = [e.engine_id for e in c.engines if not e.alive]
        require(r.crashes == 1 and dead == [1]
                and run.stream_start < c.fault_injector.plan.engine_crashes[
                    0][0],
                f"{label}: crashes {r.crashes}, dead engines {dead}")
        after = run.after_crash
        require(after is not None and after["dead_engine_frames"] == 0
                and after["prefix_frames"] >= 1
                and after["recovered_bundles"] >= 1
                and tier.frames.frames_of(1) == 0,
                f"{label}: after the crash {after}: the dead engine must "
                f"hold no host frame (its preempted requests re-leased "
                f"whole to the survivor, the rest reclaimed) while the "
                f"prefix frames survive")
        require(ts["disk_retries"] >= 1 and ts["frames_quarantined"] >= 1
                and t.lost_restarts >= 1,
                f"{label}: {ts['disk_retries']} retries, "
                f"{ts['frames_quarantined']} quarantined frames, "
                f"{t.lost_restarts} lost-payload restarts")
    if counts.get("flash_attention", 0) == 0 and not counts.get(
            "paged_attention.page"):
        return                                  # rehearsed on the CPU
    require(all(counts[k] > 0 for k in (
        "flash_attention", "paged_attention.page", "page_gather",
        "page_scatter")), f"{label}: a kernel of the path never launched: "
            f"{counts}")
    check_launches(cfg, label, t, counts)


def print_cluster_run(label, run, wall):
    import torch
    c = run.cluster
    for line in c.stats().summary().splitlines():
        print(f"[{label}] {line}")
    ms = np.asarray(run.step_s) * 1e3
    engines = " | ".join(
        f"engine {e.engine_id}: {e.stats.decode_steps} decode steps, "
        f"{e.stats.wall_s / max(e.stats.decode_steps, 1) * 1e3:.2f} ms/step "
        f"(decode {e.stats.decode_s / max(e.stats.decode_steps, 1) * 1e3:.2f})"
        for e in c.engines)
    mem = (f" | card memory high-water mark "
           f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
           if c.engines[0].device.type == "cuda" else "")
    print(f"[{label}] measured ({SMI}): wall {wall:.2f}s | {len(ms)} router "
          f"steps: {ms.mean():.2f} ms mean, {ms.max():.2f} max (host clock) "
          f"| {engines} | promotes {c.tier.stats['promoted_frames']}, "
          f"quarantined {c.tier.stats['frames_quarantined']}: frame reads "
          f"{run.promote_s * 1e3:.1f} ms (host clock), promote stall "
          f"{c.tier.stats['promote_us']:.0f} us (modeled){mem}")
    meters = [(e.stats.translation_lookups, e.stats.translation_walks)
              for e in c.engines]
    print(f"[{label}] migrations checked on the destination: "
          f"{run.landed}; translation per engine (lookups, walks): {meters}")


def check_one_copy(label, run, w_bytes):
    """The replicas hold one copy of the weights: the card's memory once
    the cluster is built, and its high-water mark while serving, stay
    below what a second copy would take."""
    import torch
    peak = torch.cuda.max_memory_allocated()
    require(run.built_bytes < 1.5 * w_bytes and peak < 2 * w_bytes,
            f"{label}: card memory {run.built_bytes / 2**30:.2f} GiB once "
            f"built, {peak / 2**30:.2f} GiB at most while serving: more "
            f"than one weight copy of {w_bytes / 2**30:.2f} GiB")


def free_cluster(run):
    """Drop a run's cluster (``ClusterRun`` wraps its router and tier in
    closures that refer back to it, so only the collector frees it) and
    return its memory to the card."""
    import gc
    import torch
    run.cluster = None
    gc.collect()
    torch.cuda.empty_cache()


def crash_plan(stream_start):
    """Phase 8b's seeded plan: engine 1 dies ``CRASH_AFTER`` router steps
    into the stream, and disk reads fail transiently at
    ``READ_ERROR_RATE`` (the tier retries); ``fault_injector`` adds the
    corrupted request frame."""
    from repro_torch.serving.faults import FaultPlan
    return FaultPlan(seed=0,
                     engine_crashes=((stream_start + CRASH_AFTER, 1),),
                     disk_read_error_rate=READ_ERROR_RATE)


def phase_cluster(cfg):
    """Phase 8a-8b at full width; returns the summed launch counts."""
    import torch
    total = {}
    sigs = []
    for i in range(2):
        run, reqs, counts, wall = serve_cluster(cfg)
        label = f"cluster:a{i + 1}"
        if i == 0:
            params = list(run.cluster.engines[0].lm.parameters())
            n_par = sum(p.numel() for p in params)
            w_bytes = sum(p.numel() * p.element_size() for p in params)
            del params
            peak = torch.cuda.max_memory_allocated()
            print(f"[cluster] built {describe(cfg, n_par)}; "
                  f"{CLUSTER_ENGINES} engines on one LM "
                  f"({w_bytes / 2**30:.2f} GiB of weights), each a pool of "
                  f"{run.cluster.engines[0].cache.pages_per_shard} pages x "
                  f"{run.cluster.engines[0].page_bytes} B; host tier "
                  f"{CLUSTER_FRAMES} frames over a spill directory; card "
                  f"memory {run.built_bytes / 2**30:.2f} GiB once built, "
                  f"high-water mark {peak / 2**30:.2f} GiB while serving")
        check_one_copy(label, run, w_bytes)
        check_cluster_run(cfg, label, run, reqs, counts)
        print_cluster_run(label, run, wall)
        print(f"[{label}] launches: {json.dumps(counts)}")
        sigs.append(cluster_signature(run, reqs))
        stream_start = run.stream_start
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        free_cluster(run)
        del run
    diff = [k for k in sigs[0] if sigs[0][k] != sigs[1][k]]
    require(not diff, f"cluster: two runs differ in {diff}")
    print("[cluster] two runs: identical tokens, router decisions, frame "
          "table, tier, spill and translation counters")
    plan = crash_plan(stream_start)
    run, reqs, counts, wall = serve_cluster(cfg, plan=plan)
    check_one_copy("cluster:b", run, w_bytes)
    check_cluster_run(cfg, "cluster:b", run, reqs, counts, faulted=True)
    print_cluster_run("cluster:b", run, wall)
    inj = run.cluster.fault_injector
    print(f"[cluster:b] plan {inj.plan} | injector {inj.stats} | tier "
          f"retries {run.cluster.tier.stats['disk_retries']}, quarantined "
          f"{run.cluster.tier.stats['frames_quarantined']}, reclaimed "
          f"{run.cluster.tier.stats['reclaimed_frames']} | lost-payload "
          f"restarts {run.cluster.stats().totals.lost_restarts}")
    print(f"[cluster:b] launches: {json.dumps(counts)}")
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n
    free_cluster(run)
    return total


def serve_translation(cfg, translation, manager_kind="mosaic", params=None,
                      device=None):
    """One phase-8c run: phase 4's stream in sync mode without
    oversubscription (so every run forms the same batches) and without the
    step hook, the translation meter in ``translation``.  Returns (engine,
    stream, batches, launch counts)."""
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, geometry=PoolGeometry(), max_batch=MAX_BATCH,
                        max_seq=MAX_SEQ, manager_kind=manager_kind,
                        fault_mode="sync", seed=0, params=params,
                        device=device, translation=translation)
    stream = make_stream(cfg.vocab_size)
    ops.reset_launch_counts()
    batches = drive(eng, stream)
    return eng, stream, batches, read_counts()


def check_translation_runs(runs):
    """Phase 8c's gates over {label: (engine, stream, batches)} for
    ``mosaic:off``, ``mosaic:flat``, ``mosaic:radix`` and
    ``gpu-mmu:radix``; returns the printed line."""
    first = runs["mosaic:off"]
    toks = {k: {r.rid: list(r.out) for _, r in v[1]} for k, v in runs.items()}
    require(all(v[2] == first[2] for v in runs.values()),
            "translation: the runs formed different batches")
    require(all(t == toks["mosaic:off"] for t in toks.values()),
            "translation: the meter changed a token")
    off, flat, radix, gmmu = (runs[k][0].stats for k in (
        "mosaic:off", "mosaic:flat", "mosaic:radix", "gpu-mmu:radix"))
    require(off.translation_lookups == 0
            and flat.translation_lookups == radix.translation_lookups > 0
            and radix.translation_walks <= flat.translation_walks,
            f"translation: lookups off/flat/radix {off.translation_lookups}"
            f"/{flat.translation_lookups}/{radix.translation_lookups}, walks "
            f"flat {flat.translation_walks} radix {radix.translation_walks}")
    return (f"[translation] off == flat == radix == gpu-mmu radix on every "
            f"batch and token; mosaic lookups {radix.translation_lookups}: "
            f"walks flat {flat.translation_walks}, radix "
            f"{radix.translation_walks} ({radix.translation_us:.0f} us "
            f"modeled); gpu-mmu radix: {gmmu.translation_lookups} lookups, "
            f"{gmmu.translation_walks} walks ({gmmu.translation_us:.0f} us "
            f"modeled)")


def phase_translation(cfg):
    """Phase 8c: the translation meter A/B on one engine at full width;
    returns the summed launch counts."""
    import torch
    total, runs = {}, {}
    lm = None
    for kind, tr in (("mosaic", "off"), ("mosaic", "flat"),
                     ("mosaic", "radix"), ("gpu-mmu", "radix")):
        eng, stream, batches, counts = serve_translation(cfg, tr, kind, lm)
        lm = eng.lm
        runs[f"{kind}:{tr}"] = (eng, stream, batches)
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        print(f"[translation:{kind}:{tr}] {eng.stats.summary()}")
    print(check_translation_runs(runs))
    del runs, lm, eng
    torch.cuda.empty_cache()
    return total


def phase_cluster_agreement(cfg_full):
    """Phase 8d: phases 8a and 8b at the narrow f32 width on the card
    (kernels) and on the CPU (plain versions): identical tokens, router
    decisions, tier counters and injector log."""
    import torch
    cfg = narrow_config(cfg_full)
    sigs = {}
    weights = None
    for dev in ("cuda", "cpu"):
        run, reqs, _c, _w = serve_cluster(cfg, device=dev, weights=weights)
        if weights is None:
            weights = {k: v.cpu() for k, v in
                       run.cluster.engines[0].lm.state_dict().items()}
        sig_a = cluster_signature(run, reqs)
        run, reqs, _c, _w = serve_cluster(
            cfg, device=dev, plan=crash_plan(run.stream_start),
            weights=weights)
        sigs[dev] = (sig_a, cluster_signature(run, reqs))
        if dev == "cuda":
            free_cluster(run)
    for i, tag in enumerate(("8a", "8b")):
        diff = [k for k in sigs["cpu"][i]
                if sigs["cpu"][i][k] != sigs["cuda"][i][k]]
        require(not diff, f"cluster agreement ({tag}): card and CPU differ "
                f"in {diff}")
    print("[cluster] narrow model, same weights, 8a and 8b: card (kernels) "
          "== CPU (plain versions) on tokens, router decisions, tier "
          "counters and the injector log")


def phase_vlm():
    """Phase 4g: llava-next-mistral-7b at its published width and depth
    through phase 4's stream and step hook at max_seq VLM_MAX_SEQ, in
    sync, async and fused; then cut to 2 layers on the card against the
    CPU with random image embeddings.  Returns the summed launch counts of
    the serving runs."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(VLM_ARCH)
    total, params = phase_main_path(cfg, MODES, tag="vlm",
                                       max_seq=VLM_MAX_SEQ)
    del params                  # llava's weights leave the card
    torch.cuda.empty_cache()
    check_agreement(dataclasses.replace(cfg, n_layers=2), "float32")
    return total


def phase_encdec():
    """Phase 4h: seamless-m4t-large-v2 at its published width and depth
    through phase 4's stream and step hook, in sync, async and fused; then
    cut to 2 + 2 layers on the card against the CPU with random source
    frames.  Returns the summed launch counts of the serving runs."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(ENCDEC_ARCH)
    total, params = phase_main_path(cfg, MODES, tag="encdec")
    del params
    torch.cuda.empty_cache()
    check_agreement(dataclasses.replace(cfg, encdec=dataclasses.replace(
        cfg.encdec, enc_layers=2, dec_layers=2)), "float32")
    return total


def phase_dense_archs():
    """Phase 4i: llama3-8b, phi3-mini-3.8b and qwen3-8b at their published
    widths and depths, one after another, the stream's first
    DENSE_REQUESTS requests in sync; qwen3-8b (qk-norm) also cut to 2
    layers on the card against the CPU.  Returns {arch: launch counts}."""
    import torch
    from repro_torch.configs import get_config
    out = {}
    for arch in DENSE_ARCHS:
        cfg = get_config(arch)
        out[arch] = phase_stream(cfg, ("sync",), DENSE_REQUESTS,
                                 tag=f"dense:{arch}")
        torch.cuda.empty_cache()
        if cfg.qk_norm:
            check_agreement(dataclasses.replace(cfg, n_layers=2), "float32")
    return out


# ---------------------------------------------------------------- training


def _scaled_err(got, want):
    """Largest absolute error of ``got`` and ``want``'s scale (max |want|)."""
    return (float((got.float() - want.float()).abs().max()),
            float(want.float().abs().max()))


def train_kernel_case(B, Tq, Tk, H, n_kv, dh, causal, dtype, tol, label,
                      seed=0, dh_v=None):
    """Phase 9a at one shape (values ``dh_v`` wide, default ``dh``): the
    forward with lse against its plain version and, bit for bit, the
    serving forward; the backward against its plain version at ``tol`` of
    each gradient's scale and bit for bit against a second call.  Returns
    the inputs and the largest errors."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dh_v = dh if dh_v is None else dh_v

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, k, v = (randn(B, Tq, H, dh) * PEAK_Q, randn(B, Tk, n_kv, dh),
               randn(B, Tk, n_kv, dh_v))
    do = randn(B, Tq, H, dh_v)
    o, lse = ops.flash_attention_lse(q, k, v, causal=causal)
    served = ops.flash_attention(q, k, v, causal=causal)
    want_o, want_lse = ref.flash_attention_lse_ref(q, k, v, causal=causal)
    grads = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    again = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal)
    torch.cuda.synchronize()
    require(torch.equal(o, served), f"{label}: the forward's o with lse is "
            f"not bit for bit the serving call's")
    o_tol = ATTN_TOL if dtype == torch.bfloat16 else dict(rtol=2e-5,
                                                          atol=2e-5)
    torch.testing.assert_close(o.float(), want_o.float(), **o_tol)
    lse_tol = 1e-4 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(lse, want_lse, rtol=lse_tol, atol=lse_tol)
    errs = []
    for name, g, g2, w in zip(("dq", "dk", "dv"), grads, again, want):
        require(bool(torch.isfinite(g.float()).all()), f"{label}: {name} "
                f"not finite")
        require(torch.equal(g, g2), f"{label}: two backward calls differ "
                f"in {name}")
        err, scale = _scaled_err(g, w)
        require(err <= tol * scale, f"{label}: {name} off its plain version "
                f"by {err:.3g} (scale {scale:.3g}, tolerance {tol})")
        errs.append(err)
    print(f"[train-kernel] {label}: o == serving o bitwise; lse max err "
          f"{float((lse - want_lse).abs().max()):.3g}; dq/dk/dv max err "
          f"{' / '.join(f'{e:.3g}' for e in errs)} (tolerance {tol} of "
          f"scale); two backward calls bitwise equal")
    return (q, k, v, o, do, lse), max(errs), float(
        (o.float() - want_o.float()).abs().max())


def sdpa_grad_ms(q, k, v, do, causal):
    """``scaled_dot_product_attention``'s times on the flash backward's
    inputs ([B, T, H, dh] as the port takes them): forward + backward
    through autograd, and its backward alone over one fixed forward."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (qt, kt, vt))

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                             enable_gqa=True)
        torch.autograd.grad(out, (qg, kg, vg), dot)

    # The backward alone over one fixed forward.  The leaves and the
    # forward live on a side stream: autograd runs the backward there, and
    # a capture may not make the legacy default stream wait on itself.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qb, kb, vb = (x.detach().clone().requires_grad_()
                      for x in (qt, kt, vt))
        out_b = F.scaled_dot_product_attention(qb, kb, vb, is_causal=causal,
                                               enable_gqa=True)
    torch.cuda.current_stream().wait_stream(side)

    def bwd():
        torch.autograd.grad(out_b, (qb, kb, vb), dot, retain_graph=True)

    return graph_ms(fwd_bwd), graph_ms(bwd)


def flash_fwd_bound(B, Tq, Tk, H, n_kv, dh, causal, dh_v=None):
    """Bytes (q, k, v read once; o and lse written once, in bf16) and
    operations (the two products over the pairs a row sees, Q K^T over dh
    and P V over dh_v, default dh) of one flash forward with lse."""
    dh_v = dh if dh_v is None else dh_v
    pairs = Tq * (Tq + 1) // 2 if causal else Tq * Tk
    rows_q, rows_kv = B * Tq * H, B * Tk * n_kv
    return bound_ms(2 * (rows_q + rows_kv) * (dh + dh_v) + 4 * B * H * Tq,
                    2 * B * H * pairs * (dh + dh_v))


def flash_bwd_bound(B, Tq, Tk, H, n_kv, dh, causal, dh_v=None):
    """Bytes (q, k, v, o, dO and lse read once; dq, dk, dv written once, in
    bf16) and operations (the five products over the pairs a row sees:
    S = Q K^T, dQ and dK over dh, dP = dO V^T and dV over dh_v, default
    dh) of one flash-backward call."""
    dh_v = dh if dh_v is None else dh_v
    pairs = Tq * (Tq + 1) // 2 if causal else Tq * Tk
    rows_q, rows_kv = B * Tq * H, B * Tk * n_kv
    return bound_ms(2 * 2 * (rows_q + rows_kv) * (dh + dh_v)
                    + 4 * B * H * Tq,
                    2 * B * H * pairs * (3 * dh + 2 * dh_v))


def phase_train_kernels(results):
    """Phase 9a: the training kernels at qwen2.5-3b's training shape, at
    the narrow model's f32 shape and non-causal with Tq != Tk; entries
    ``flash_attention.train`` and ``flash_attention_bwd`` in ``results``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    B, T, H, n_kv, dh = TRAIN_B, TRAIN_T, 16, 2, 128
    (q, k, v, o, do, lse), bwd_err, fwd_err = train_kernel_case(
        B, T, T, H, n_kv, dh, True, torch.bfloat16, ATTN_TOL["rtol"],
        f"qwen2.5-3b training shape B={B} T={T} H={H} n_kv={n_kv} dh={dh}")
    train_kernel_case(2, NARROW_T, NARROW_T, 4, 2, 32, True, torch.float32,
                      2e-5, f"narrow f32 B=2 T={NARROW_T} H=4 n_kv=2 dh=32")
    train_kernel_case(2, 300, 700, H, n_kv, dh, False, torch.bfloat16,
                      ATTN_TOL["rtol"], "non-causal Tq=300 Tk=700 bf16")
    fwd_bound = flash_fwd_bound(B, T, T, H, n_kv, dh, True)
    bwd_bound = flash_bwd_bound(B, T, T, H, n_kv, dh, True)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa_ms, sdpa_bwd_ms = sdpa_grad_ms(q, k, v, do, True)
    shape = f"B={B} T={T} H={H} n_kv={n_kv} dh={dh} causal bf16"
    results["flash_attention.train"] = dict(
        max_abs_err=fwd_err,
        ms=graph_ms(functools.partial(ops.flash_attention_lse, q, k, v)),
        plain_ms=eager_ms(functools.partial(ref.flash_attention_lse_ref, q,
                                            k, v), iters=5),
        bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
        library_ms=graph_ms(functools.partial(
            F.scaled_dot_product_attention, qt, kt, vt, is_causal=True,
            enable_gqa=True)), shape=shape)
    results["flash_attention_bwd"] = dict(
        max_abs_err=bwd_err,
        ms=graph_ms(functools.partial(ops.flash_attention_bwd, q, k, v, o, do,
                                      lse)),
        plain_ms=eager_ms(functools.partial(ref.flash_attention_bwd_ref, q,
                                            k, v, o, do, lse), iters=5),
        bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
        library_ms=sdpa_ms, library_bwd_ms=sdpa_bwd_ms, shape=shape)
    f, b = results["flash_attention.train"], results["flash_attention_bwd"]
    print(f"[kernel] flash_attention.train: kernel_ms {f['ms']:.4f} plain_ms "
          f"{f['plain_ms']:.4f} bound_ms {f['bound_ms']:.5f} "
          f"({f['bound_by']}) library_ms {f['library_ms']:.4f} "
          f"(scaled_dot_product_attention forward) | {shape}")
    # The launches as csrc/flash_attention_bwd.cu's launch_tc makes them:
    # dQ over 64 rows = g heads x 64 / g positions, writing D; then dK / dV
    # in clusters of c = min(g, 4) CTAs per 64-key tile.
    g = H // n_kv
    c = min(g, 4)
    n_q, n_kt = -(-T // (64 // g)), -(-T // 64)
    print(f"[kernel] flash_attention_bwd: kernel_ms {b['ms']:.4f} plain_ms "
          f"{b['plain_ms']:.4f} bound_ms {b['bound_ms']:.5f} "
          f"({b['bound_by']}) library_ms {b['library_ms']:.4f} "
          f"(scaled_dot_product_attention forward + backward through "
          f"autograd; the port's forward + backward: "
          f"{f['ms'] + b['ms']:.4f}) library_bwd_ms "
          f"{b['library_bwd_ms']:.4f} (its backward alone; the port's: "
          f"{b['ms']:.4f}) | {shape} | one count, two launches a call, one "
          f"warpgroup a CTA on wgmma: dQ, which also writes D (grid "
          f"{n_q * n_kv * B} = {n_q} x {n_kv} x {B}), then dK/dV (grid "
          f"{c * n_kt * n_kv * B} = {c} ranks x {n_kt} key tiles x {n_kv} x "
          f"{B}, clusters of {c}, {g // c} heads a rank)")


# ------------------------------------------------ optimizer-step kernels

OPTIM_STEP = 3          # phase 9a's AdamW entry: the bias corrections and
#                         learning rate of update 3 of 9b's schedule
OPTIM_SCALE = 0.37      # its clip factor: a clipped step


def model_leaves(cfg):
    """(name, shape) of ``cfg``'s parameters as ``Trainer`` holds them on
    one rank (fp32 masters), from an LM on the meta device."""
    from repro_torch.models.lm import LM
    return [(n, tuple(p.shape)) for n, p in
            LM(cfg, device="meta", master=True).named_parameters()]


def leaf_count(cfg):
    """Non-empty leaves of ``cfg``: AdamW launches a step on one rank."""
    return sum(1 for _, shape in model_leaves(cfg) if math.prod(shape))


def division_form():
    """How the card's eager chain divides a CUDA tensor by a CPU scalar
    (``mu / c1``, ``nu / c2``, ``/ 127.0``): "reciprocal" where every
    quotient is x * (1.0f / c) bit for bit and some differs from the IEEE
    x / c, "ieee" for the reverse, else "other".  ``csrc/adamw.cu`` and
    ``csrc/grad_quant.cu`` reproduce "reciprocal"."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(1 << 22, generator=gen, device="cuda")
    forms = {}
    for c in (0.271, 0.999, 0.0975, 127.0):
        c32 = torch.tensor(c, dtype=torch.float32)
        eager = x / (c if c == 127.0 else c32)   # _quant divides by 127.0
        recip = x * (torch.tensor(1.0) / c32).cuda()
        ieee = x / c32.cuda()
        forms[c] = ("reciprocal" if torch.equal(eager, recip)
                    and not torch.equal(recip, ieee) else
                    "ieee" if torch.equal(eager, ieee)
                    and not torch.equal(recip, ieee) else "other")
    return forms


def adamw_leaves(shapes, p_dtype, g_dtype, seed):
    """(p, g, mu, nu) on the card for each shape, from a seed: p ~ 0.02 N,
    g ~ 1e-3 N, mu ~ 1e-4 N, nu ~ 1e-6 U(0, 1)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for shape in shapes:
        def draw(k, dtype, uniform=False):
            t = torch.empty(shape, dtype=torch.float32, device="cuda")
            (t.uniform_(generator=gen) if uniform
             else t.normal_(generator=gen)).mul_(k)
            return t.to(dtype)
        out.append((draw(0.02, p_dtype), draw(1e-3, g_dtype),
                    draw(1e-4, torch.float32),
                    draw(1e-6, torch.float32, uniform=True)))
    return out


def adamw_kwargs():
    """The scalars of phase 9a's AdamW entry: update OPTIM_STEP of 9b's
    schedule (``adamw_scalars``) and the reference's b1, b2, eps."""
    import torch
    from repro_torch.configs.base import TrainHParams
    from repro_torch.train.optimizer import adamw_scalars
    hp = TrainHParams(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS,
                      remat="block")
    lr, c1, c2, decay = adamw_scalars(
        hp, torch.tensor(OPTIM_STEP, dtype=torch.int32))
    return dict(lr=lr, c1=c1, c2=c2, decay=decay, b1=hp.b1, b2=hp.b2,
                eps=hp.eps)


def check_adamw(leaves, scale, kw, label):
    """Each leaf's kernel update against the plain version on copies of
    its inputs, p, mu and nu bit for bit; returns the largest absolute
    difference (0)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.optimizer import adamw_leaf
    worst = 0.0
    for p, g, mu, nu in leaves:
        want = [t.clone() for t in (p, g, mu, nu)]
        ref.adamw_leaf_ref(*want, scale, **kw)
        adamw_leaf(p, g, mu, nu, scale, **kw)
        for name, got, w in (("p", p, want[0]), ("mu", mu, want[2]),
                             ("nu", nu, want[3])):
            if got.numel():
                worst = max(worst, float((got.float() - w.float()).abs()
                                         .max()))
            require(torch.equal(got, w), f"{label}: adamw's {name} of a "
                    f"{tuple(p.shape)} {p.dtype} leaf (g {g.dtype}) is not "
                    f"its plain version's bit for bit")
        del want
    return worst


def quant_vectors(sizes, seed):
    """(g, e) flat f32 on the card for each size: g ~ 1e-3 N, e ~ 1e-5 N."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [(torch.randn(n, generator=gen, device="cuda").mul_(1e-3),
             torch.randn(n, generator=gen, device="cuda").mul_(1e-5))
            for n in sizes]


def check_grad_quant(vectors, label):
    """The error-feedback pass on each (g, e) against the plain version on
    copies: Q(g + e) and e' equal, NaN where it has NaN;
    returns the largest absolute difference (0)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.optimizer import grad_quant
    worst = 0.0
    for g, e in vectors:
        want = ref.ef_quant_ref(g.clone(), e.clone())
        got = grad_quant(g, e)
        for name, a, b in zip(("Q(g + e)", "e'"), got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                       msg=lambda m: f"{label}: grad_quant's "
                                       f"{name} at n={g.numel()}: {m}")
            d = (a.float() - b.float()).abs()
            d = d[~d.isnan()]           # NaN in both, where the input has one
            if d.numel():
                worst = max(worst, float(d.max()))
    return worst


def phase_optim_kernels(results):
    """Phase 9a, the optimizer-step kernels (entries ``adamw`` and
    ``grad_quant``): first the division form of the card's eager chain
    (``division_form``), then each kernel against its plain version on
    the card, bit for bit, at odd sizes (one 256-element block, 257 x 256,
    an empty leaf, 4099 and 65795 elements for AdamW's vector tail, bf16 p
    and g, and for the quantiser an all-zero block, an outlier, a NaN and
    the quantise mode) and at qwen2.5-3b's 14 full-width
    leaves as phase 9b holds them (the quantiser's padded to 256); times by
    graph replay over the 14 leaves (one launch each), the plain versions'
    by CUDA events, ``torch._fused_adamw_`` over the same tensor lists as
    AdamW's yardstick of time (it places eps and the bias corrections
    otherwise); bounds: 28 bytes an element (AdamW) and 16 (the
    quantiser's error-feedback pass) at 3.35 TB/s."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainHParams
    from repro_torch.kernels import ref
    from repro_torch.kernels.optimizer import adamw_leaf, grad_quant
    from repro_torch.train.grad_compress import padded_size
    gc.collect()
    torch.cuda.empty_cache()
    forms = division_form()
    print(f"[kernel] division of a CUDA tensor by a CPU scalar in the eager "
          f"chain, by divisor: {forms}")
    require(set(forms.values()) == {"reciprocal"}, f"the eager chain's "
            f"division is not x * (1.0f / c) for every divisor: {forms}; "
            f"csrc/adamw.cu and csrc/grad_quant.cu assume it is")
    kw = adamw_kwargs()
    scale = torch.tensor(OPTIM_SCALE, device="cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    odd = (256, 257 * 256, 0, 4099, 65795)
    for p_dt, g_dt in ((f32, f32), (bf16, bf16), (bf16, f32), (f32, bf16)):
        check_adamw(adamw_leaves([(n,) for n in odd], p_dt, g_dt, 7), scale,
                    kw, f"9a adamw odd sizes p {p_dt} g {g_dt}")
    print(f"[kernel] adamw: bit for bit its plain version at {odd} "
          f"elements, p / g in f32 / f32, bf16 / bf16, bf16 / f32, f32 / "
          f"bf16 (an empty leaf launches nothing)")
    vecs = quant_vectors((256, 257 * 256, 0), 8)
    g, e = vecs[1]
    g[:256] = 0.0
    e[:256] = 0.0                       # an all-zero block
    g[256 + 9] = 40.0                   # an outlier
    g[5 * 256 + 3] = float("nan")       # a NaN gradient
    check_grad_quant(vecs, "9a grad_quant odd sizes")
    require(bool(g[5 * 256:6 * 256].isnan().all()) and bool(
        e[5 * 256:6 * 256].isnan().all()) and bool(
        torch.isfinite(g[6 * 256:]).all()), "9a grad_quant: a NaN "
        "gradient does not make its block, and only its block, NaN")
    x = quant_vectors((257 * 256,), 10)[0][0]
    for a, b in zip(grad_quant(x), ref.quant_ref(x)):
        require(torch.equal(a, b), "9a grad_quant: the quantise mode is not "
                "quant_ref's bit for bit")
    print("[kernel] grad_quant: bit for bit its plain version at 256, "
          "257 x 256 (an all-zero block, an outlier, a NaN: its block NaN, "
          "the rest finite) and 0 elements, and in quantise mode")
    del vecs, g, e, x

    shapes = [s for _, s in model_leaves(get_config(ARCH))]
    n_el = sum(math.prod(s) for s in shapes)
    leaves = adamw_leaves(shapes, f32, f32, 11)
    err = check_adamw(leaves, scale, kw, "9a adamw at qwen2.5-3b's leaves")

    def update():
        for p, g, mu, nu in leaves:
            adamw_leaf(p, g, mu, nu, scale, **kw)

    def plain():
        for p, g, mu, nu in leaves:
            ref.adamw_leaf_ref(p, g, mu, nu, scale, **kw)

    lists = [list(t) for t in zip(*leaves)]
    steps = [torch.tensor(float(OPTIM_STEP), device="cuda") for _ in shapes]

    def library():
        torch._fused_adamw_(*lists, [], steps, lr=float(kw["lr"]),
                            beta1=kw["b1"], beta2=kw["b2"],
                            weight_decay=TrainHParams().weight_decay,
                            eps=kw["eps"],
                            amsgrad=False, maximize=False)
    ms = graph_ms(update, reps=5, replays=3)
    lib_ms = graph_ms(library, reps=5, replays=3)
    plain_ms = eager_ms(plain, iters=3)
    bound = bound_ms(28 * n_el + 4)
    shape = (f"qwen2.5-3b's {len(shapes)} leaves, {n_el} f32 elements, one "
             f"launch a leaf")
    results["adamw"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound[0], bound_by=bound[1],
                            library_ms=lib_ms, shape=shape)
    print(f"[kernel] adamw: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
          f"bound_ms {bound[0]:.5f} ({bound[1]}: 28 B an element) "
          f"library_ms {lib_ms:.4f} (torch._fused_adamw_ over the same "
          f"lists; other placement of eps and the bias corrections) | "
          f"{shape}; max_abs_err {err} ({SMI})")
    del leaves, lists, steps
    gc.collect()
    torch.cuda.empty_cache()

    sizes = [padded_size(math.prod(s)) for s in shapes]
    vecs = quant_vectors(sizes, 12)
    err = check_grad_quant(vecs, "9a grad_quant at qwen2.5-3b's leaves")

    def quantise():
        for g, e in vecs:
            grad_quant(g, e)

    def plain_q():
        for g, e in vecs:
            ref.ef_quant_ref(g, e)
    ms = graph_ms(quantise, reps=5, replays=3)
    plain_ms = eager_ms(plain_q, iters=3)
    n_q = sum(sizes)
    bound = bound_ms(16 * n_q)
    shape = (f"qwen2.5-3b's {len(sizes)} leaves padded to 256, {n_q} f32 "
             f"elements, error feedback on one rank (Q(g + e) over g, e' "
             f"over e), one launch a leaf")
    results["grad_quant"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound[0], bound_by=bound[1],
                                 library_ms=None, shape=shape)
    print(f"[kernel] grad_quant: kernel_ms {ms:.4f} plain_ms "
          f"{plain_ms:.4f} bound_ms {bound[0]:.5f} ({bound[1]}: 16 B an "
          f"element) library_ms none (no single call) | {shape}; "
          f"max_abs_err {err} ({SMI})")
    del vecs
    gc.collect()
    torch.cuda.empty_cache()


def phase_train(cfg):
    """Phase 9b: full-width training through ``Trainer``; returns the
    training kernels' launch counts of the run."""
    import torch
    from repro_torch.configs.base import TrainHParams
    from repro_torch.kernels import ops
    from repro_torch.train.trainer import Trainer
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    hp = TrainHParams(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS,
                      remat="block")
    t0 = time.perf_counter()
    tr = Trainer(cfg, hp, batch_per_step=TRAIN_B, seq_len=TRAIN_T, seed=0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    ops.reset_launch_counts()
    hist = tr.run(TRAIN_STEPS, log_every=1)
    counts = ops.train_launch_counts()
    serving = {**ops.launch_counts(), **ops.train_site_counts()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    L, tokens = cfg.n_layers, TRAIN_B * TRAIN_T
    for r in tr.log:
        print(f"[train] step {r['step']}: loss {r['loss']:.4f} grad_norm "
              f"{r['grad_norm']:.4f} step_ms {r['ms']:.1f} tokens/s "
              f"{tokens / r['ms'] * 1e3:.0f}")
    losses = [l for _, l in hist]
    require(len(tr.log) == TRAIN_STEPS
            and all(np.isfinite([r["loss"], r["grad_norm"]]).all()
                    for r in tr.log),
            f"training: a loss or grad norm is not finite: {tr.log}")
    require(counts == {"flash_attention.train": 2 * L * TRAIN_STEPS,
                       "flash_attention_bwd": L * TRAIN_STEPS,
                       "ssd_scan_bwd": 0,
                       "adamw": leaf_count(cfg) * TRAIN_STEPS,
                       "grad_quant": 0}
            and not any(serving.values()),
            f"training: launches {counts} (serving and by site {serving}) "
            f"are not two forwards and one backward per layer and step "
            f"and one AdamW launch per leaf and step")
    steady = [r["ms"] for r in tr.log[1:]]
    print(f"[train] {cfg.name} at its published width and depth "
          f"({cfg.param_count() / 1e9:.3f} G parameters, fp32 master "
          f"weights, bf16 compute), batch {TRAIN_B} x seq {TRAIN_T}, "
          f"remat block: {TRAIN_STEPS} steps in "
          f"{sum(r['ms'] for r in tr.log) / 1e3:.1f}s after {t_init:.1f}s "
          f"of set-up; steps 2-{TRAIN_STEPS} median "
          f"{float(np.median(steady)):.1f} ms ({tokens / float(np.median(steady)) * 1e3:.0f} "
          f"tokens/s); loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches "
          f"{counts}; peak memory {peak:.2f} GiB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f} "
          f"({held:.2f} GiB held before) ({SMI})")
    with torch.no_grad():
        after = float(tr.lm.loss(tr.data.batch_at(TRAIN_STEPS - 1))[0])
    require(after < losses[-1] and after < losses[0],
            f"training: the final weights' loss on the last step's batch, "
            f"{after:.4f}, is not below its loss before the update, "
            f"{losses[-1]:.4f}, and the first step's, {losses[0]:.4f}")
    print(f"[train] the loss falls: the final weights' loss on step "
          f"{TRAIN_STEPS}'s batch {after:.4f} < {losses[-1]:.4f} before its "
          f"update and < step 1's {losses[0]:.4f}")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    tr = Trainer(dataclasses.replace(cfg, dtype="float32"), hp,
                 batch_per_step=TRAIN_B, seq_len=TRAIN_T, seed=0)
    tr.run(TRAIN_STEPS, log_every=1)
    f32 = [r["loss"] for r in tr.log]
    # bf16 rounds activations at 2^-8 of their scale; the loss averages
    # 4094 tokens, so the runs stay far inside 1e-3.
    require(all(abs(a - b) <= 1e-3 * abs(b) for a, b in zip(losses, f32)),
            f"training: bf16 losses {losses} off the f32 run's {f32}")
    print(f"[train] the same {TRAIN_STEPS} steps with f32 compute (CUDA-core "
          f"attention kernels, f32 products): losses "
          f"{[round(l, 4) for l in f32]}, largest relative difference "
          f"{max(abs(a - b) / abs(b) for a, b in zip(losses, f32)):.2e} "
          f"from the bf16 run's")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def train_agreement(dev="cuda", arch=ARCH, against_cpu=True):
    """Phase 9c's checks with ``arch``'s narrow model
    (``narrow_train_config``) on ``dev`` (the card; the CPU rehearses
    them): with ``against_cpu`` 4 steps' losses against the CPU's, then a
    checkpoint-resume against the uninterrupted run, bitwise.  (The moe
    family's card-vs-CPU losses are phase 9h's, which replays the card's
    expert choices; here it takes only the resume.)"""
    import torch
    from repro_torch.configs.base import TrainHParams
    from repro_torch.train.trainer import Trainer
    cfg = narrow_train_config(arch)
    hp = TrainHParams(lr=1e-3, warmup_steps=1, total_steps=4, remat="block")
    kw = dict(batch_per_step=2, seq_len=NARROW_T, seed=0, device=dev)
    card = Trainer(cfg, hp, **kw)
    weights = {n: p.detach().cpu().clone() for n, p in card.params.items()}
    card.run(4, log_every=1)
    if against_cpu:
        cpu = Trainer(cfg, hp, params=weights, **dict(kw, device="cpu"))
        cpu.run(4, log_every=1)
        for a, b in zip(card.log, cpu.log):
            require(abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"]),
                    f"narrow training: card loss {a['loss']} != CPU loss "
                    f"{b['loss']} at step {a['step']}")
        print(f"[train:agreement] narrow f32 {arch}, same weights, 4 steps: "
              f"card losses {[round(r['loss'], 6) for r in card.log]} "
              f"within 1e-4 of the CPU's "
              f"{[round(r['loss'], 6) for r in cpu.log]}")
    # One directory per model: the CPU tests rehearse two models at once.
    d = ROOT / "build" / f"train_ckpt.{arch}"
    shutil.rmtree(d, ignore_errors=True)
    try:
        first = Trainer(cfg, hp, params=weights, ckpt_dir=str(d),
                        ckpt_every=2, **kw)
        first.run(2, log_every=1)
        del first
        resumed = Trainer(cfg, hp, params=weights, ckpt_dir=str(d),
                          resume=True, **kw)
        require(resumed.start_step == 2, f"resume started at "
                f"{resumed.start_step}, not at the step-2 checkpoint")
        resumed.run(2, log_every=1)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for n, p in card.params.items():
        require(torch.equal(p, resumed.params[n])
                and torch.equal(card.opt["mu"][n], resumed.opt["mu"][n])
                and torch.equal(card.opt["nu"][n], resumed.opt["nu"][n]),
                f"checkpoint-resume: {n} or its moments differ from the "
                f"uninterrupted run")
    require(int(resumed.opt["step"]) == int(card.opt["step"]) == 4,
            "checkpoint-resume: step counters differ")
    print(f"[train:restart] narrow f32 {arch}: checkpoint at step 2, resumed "
          f"in a fresh Trainer for 2 steps: parameters and Adam moments bit "
          f"for bit the uninterrupted 4-step run's")


def deterministic_train_agreement():
    """Phase 9c's child process: deterministic algorithms, TF32 off; the
    dense narrow model's agreement and resume, then the narrow
    deepseek-v2-lite's resume (MLA attention, MoE dispatch and combine
    under the deterministic algorithms)."""
    import torch
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train_agreement("cuda")
    train_agreement("cuda", MLA_ARCH, against_cpu=False)


def phase_train_agreement():
    """Phase 9c: ``train_agreement`` in a subprocess, so that
    CUBLAS_WORKSPACE_CONFIG is set before CUDA starts and
    ``torch.use_deterministic_algorithms(True)`` makes a nondeterministic
    op raise instead of flaking."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "chip_smoke.deterministic_train_agreement()")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], env=env,
                         capture_output=True, text=True, timeout=600)
    for line in out.stdout.splitlines():
        if line.startswith("[train:"):
            print(line)
    require(out.returncode == 0, f"phase 9c failed (exit {out.returncode}): "
            f"{out.stdout[-2000:]}{out.stderr[-3000:]}")


# ------------------------------------------------ training of the families


# Phase 9a's flash shapes of phases 9d, 9e and 9g: (entry tag, label, B,
# Tq, Tk, H, n_kv, dh, causal).  Entries ``flash_attention.train.<tag>`` and
# ``flash_attention_bwd.<tag>``.
# Phase 9a's flash shapes of the moe family: (entry tag, label, B, Tq, Tk,
# H, n_kv, dh, dh_v, causal).  deepseek-v2-lite's MLA attention is phase
# 9i's; dbrx-132b trains on the card only as the narrow model of 9h, so its
# entries have no launches (ZERO_LAUNCHES).
MOE_FLASH_SHAPES = (
    ("mla", "deepseek-v2-lite MLA attention", TRAIN_B, TRAIN_T, TRAIN_T, 16,
     16, 192, 128, True),
    ("moe", "dbrx-132b attention", TRAIN_B, TRAIN_T, TRAIN_T, 48, 8, 128, 128,
     True),
)
ZERO_LAUNCHES = dict.fromkeys(
    ("flash_attention.train.moe", "flash_attention_bwd.moe"),
    "no dbrx-132b training fits the card: one layer at its published widths "
    "is 4.49 G parameters, ~81 GB of training state (fp32 master, grad, "
    "AdamW moments, bf16 copy); its attention shape is held and timed here "
    "and its narrow f32 model trains in phase 9h")

FLASH_BWD_SHAPES = (
    ("vlm", "llava-next self-attention", 1, VLM_TRAIN_P + VLM_TRAIN_T,
     VLM_TRAIN_P + VLM_TRAIN_T, 32, 8, 128, True),
    ("encoder", "seamless-m4t encoder", ENCDEC_TRAIN_B, ENCDEC_SRC,
     ENCDEC_SRC, 16, 16, 64, False),
    ("cross", "seamless-m4t cross-attention", ENCDEC_TRAIN_B, ENCDEC_TRAIN_T,
     ENCDEC_SRC, 16, 16, 64, False),
    ("decoder", "seamless-m4t decoder self-attention", ENCDEC_TRAIN_B,
     ENCDEC_TRAIN_T, ENCDEC_TRAIN_T, 16, 16, 64, True),
    ("hybrid", "zamba2 shared block", TRAIN_B, TRAIN_T, TRAIN_T, 32, 32, 64,
     True),
)


def ssd_bwd_bound(B, T, nh, hd, N, G, Q, in_bytes):
    """Bytes (x, B and C at their G groups in the input dtype, dt, A and dy
    in f32 read once; dx, dB, dC in the input dtype and d dt, dA in f32
    written once) and operations (per causal pair of a chunk C . B, dy . x,
    and the three products that take them: dC, dB, dx; per row the
    recomputed chunk states, the state gradients and the carried terms)
    of one SSD-scan backward call."""
    nbytes = (2 * in_bytes * B * T * (nh * hd + 2 * G * N)
              + 4 * B * T * nh * (2 + hd) + 8 * nh)
    pairs = Q * (Q + 1) // 2 * (T // Q)
    flops = B * nh * (pairs * (6 * N + 4 * hd) + 10 * T * hd * N)
    return bound_ms(nbytes, flops)


def ssd_bwd_inputs(B, T, nh, hd, N, G, dtype, with_h0, seed):
    """Inputs drawn as tests/test_kernels.py draws the scan's (dt in
    [0.01, 0.2], A in [-2, -0.5]), and dy ~ N(0, 1)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, dt_=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dt_)

    def unif(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device="cuda")
    x = randn(B, T, nh, hd, dt_=dtype)
    Bm, Cm = randn(B, T, G, N, dt_=dtype), randn(B, T, G, N, dt_=dtype)
    h0 = randn(B, nh, hd, N) if with_h0 else None
    return ((x, unif(0.01, 0.2, B, T, nh), -unif(0.5, 2.0, nh), Bm, Cm, h0),
            randn(B, T, nh, hd))


def ssd_bwd_case(label, shape, dtype, tol, with_h0=False, seed=3):
    """Phase 9a's SSD backward at one shape (B, T, nh, hd, N, G, Q) against
    its plain version, at ``tol`` of each gradient's scale, and bit for
    bit against a second call.  Returns (inputs, dy, largest error)."""
    import torch
    from repro_torch.kernels import ops, ref
    B, T, nh, hd, N, G, Q = shape
    args, dy = ssd_bwd_inputs(B, T, nh, hd, N, G, dtype, with_h0, seed)
    dh = torch.randn_like(args[5]) if with_h0 else None
    got = ops.ssd_scan_bwd(*args[:5], dy, dh, chunk=Q, h0=args[5])
    again = ops.ssd_scan_bwd(*args[:5], dy, dh, chunk=Q, h0=args[5])
    want = ref.ssd_scan_bwd_ref(*args[:5], dy, dh, chunk=Q, h0=args[5])
    torch.cuda.synchronize()
    errs = []
    for name, g, g2, w in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), got,
                              again, want):
        if w is None:
            continue
        require(bool(torch.isfinite(g.float()).all()),
                f"{label}: {name} not finite")
        require(torch.equal(g, g2), f"{label}: two backward calls differ "
                f"in {name}")
        err, scale = _scaled_err(g, w)
        require(err <= tol * scale, f"{label}: {name} off its plain version "
                f"by {err:.3g} (scale {scale:.3g}, tolerance {tol})")
        errs.append(f"{name} {err:.3g}/{scale:.3g}")
    print(f"[train-kernel] ssd_scan_bwd {label}: max err / scale "
          f"{'; '.join(errs)} (tolerance {tol} of scale); two calls bitwise "
          f"equal")
    return args, dy, max(float((g.float() - w.float()).abs().max())
                         for g, w in zip(got, want) if w is not None)


def phase_family_train_kernels(results):
    """Phase 9a at the shapes of phases 9d-9g: the SSD-scan backward at
    mamba2-1.3b's and zamba2-1.2b's training shapes in bf16 (entries
    ``ssd_scan_bwd`` and ``ssd_scan_bwd.hybrid``) and at the narrow f32
    shape over three chunks, with an initial state and the final state's
    gradient; the training forward of the scan at both training shapes
    (``ssd_scan.train``, ``ssd_scan.train.hybrid``); the flash forward with
    lse and the backward at FLASH_BWD_SHAPES (``flash_attention.train.<tag>``
    and ``flash_attention_bwd.<tag>``)."""
    import torch
    from repro_torch.kernels import ops, ref
    shapes = (("", "mamba2-1.3b", (TRAIN_B, TRAIN_T, 64, 64, 128, 1, 256)),
              (".hybrid", "zamba2-1.2b", (TRAIN_B, TRAIN_T, 64, 64, 64, 1,
                                          256)))
    for tag, name, shape in shapes:
        args, dy, err = ssd_bwd_case(f"{name} training shape {shape}",
                                     shape, torch.bfloat16, SSD_BWD_TOL)
        B, T, nh, hd, N, G, Q = shape
        desc = (f"B={B} T={T} nh={nh} hd={hd} N={N} G={G} Q={Q} bf16 "
                f"({name})")
        b_ms, b_by = ssd_bwd_bound(*shape, 2)
        results[f"ssd_scan_bwd{tag}"] = r = dict(
            max_abs_err=err,
            ms=graph_ms(functools.partial(ops.ssd_scan_bwd, *args[:5], dy,
                                          chunk=Q), reps=5, replays=3),
            plain_ms=eager_ms(functools.partial(
                ref.ssd_scan_bwd_ref, *args[:5], dy, chunk=Q), iters=2),
            bound_ms=b_ms, bound_by=b_by, library_ms=None, shape=desc)
        print(f"[kernel] ssd_scan_bwd{tag}: kernel_ms {r['ms']:.4f} "
              f"plain_ms {r['plain_ms']:.4f} bound_ms {b_ms:.5f} ({b_by}) "
              f"library_ms none (no single PyTorch call computes an SSD "
              f"scan's gradient) | {desc} | seven launches a call (the "
              f"chunk states, the state pass and both pair passes on the "
              f"tensor cores), one count ({SMI})")
        y, h = ops.ssd_scan(*args[:5], chunk=Q)
        y_r, h_r = ref.ssd_scan_ref(*args[:5], chunk=Q)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, y_r, **SSD_TOL)
        torch.testing.assert_close(h, h_r, **SSD_TOL)
        f_ms, f_by = ssd_bound(B, T, nh, hd, N, Q, False, G)
        results[f"ssd_scan.train{tag}"] = r = dict(
            max_abs_err=max(float((y - y_r).abs().max()),
                            float((h - h_r).abs().max())),
            ms=graph_ms(functools.partial(ops.ssd_scan, *args[:5], chunk=Q),
                        reps=5),
            plain_ms=eager_ms(functools.partial(
                ref.ssd_scan_ref, *args[:5], chunk=Q), iters=2),
            bound_ms=f_ms, bound_by=f_by, library_ms=None, shape=desc)
        print(f"[kernel] ssd_scan.train{tag}: max_abs_err "
              f"{r['max_abs_err']:.3g} | kernel_ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} bound_ms {f_ms:.5f} ({f_by}) library_ms "
              f"none | {desc}, the training forward")
        del args, dy, y, h, y_r, h_r
    T3 = 3 * 256
    ssd_bwd_case(f"narrow f32 (2, {T3}, 4, 64, 128, 1, 256), three chunks, "
                 f"h0 and dh", (2, T3, 4, 64, 128, 1, 256), torch.float32,
                 2e-5, with_h0=True)
    for tag, label, B, Tq, Tk, H, n_kv, dh, causal in FLASH_BWD_SHAPES:
        flash_train_entry(results, tag, label, B, Tq, Tk, H, n_kv, dh, causal)


def flash_train_entry(results, tag, label, B, Tq, Tk, H, n_kv, dh, causal,
                      dh_v=None):
    """Phase 9a's flash forward with lse and backward at one bf16 training
    shape (``train_kernel_case``), timed beside their bounds and SDPA's:
    entries ``flash_attention.train.<tag>`` and
    ``flash_attention_bwd.<tag>``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    kind = "causal" if causal else "non-causal"
    widths = f"dh={dh}" if dh_v is None else f"dh={dh} dh_v={dh_v}"
    shape = f"B={B} Tq={Tq} Tk={Tk} H={H} n_kv={n_kv} {widths} {kind} bf16"
    (q, k, v, o, do, lse), err, fwd_err = train_kernel_case(
        B, Tq, Tk, H, n_kv, dh, causal, torch.bfloat16,
        ATTN_TOL["rtol"], f"{label} {shape}", dh_v=dh_v)
    f_ms, f_by = flash_fwd_bound(B, Tq, Tk, H, n_kv, dh, causal, dh_v)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    results[f"flash_attention.train.{tag}"] = f = dict(
        max_abs_err=fwd_err,
        ms=graph_ms(functools.partial(ops.flash_attention_lse, q, k, v,
                                      causal=causal), reps=5),
        plain_ms=eager_ms(functools.partial(
            ref.flash_attention_lse_ref, q, k, v, causal=causal),
            iters=2),
        bound_ms=f_ms, bound_by=f_by,
        library_ms=graph_ms(functools.partial(
            F.scaled_dot_product_attention, qt, kt, vt, is_causal=causal,
            enable_gqa=True), reps=5), shape=shape)
    del qt, kt, vt
    print(f"[kernel] flash_attention.train.{tag}: kernel_ms "
          f"{f['ms']:.4f} plain_ms {f['plain_ms']:.4f} bound_ms "
          f"{f_ms:.5f} ({f_by}) library_ms {f['library_ms']:.4f} "
          f"(scaled_dot_product_attention forward) | {label} {shape}")
    b_ms, b_by = flash_bwd_bound(B, Tq, Tk, H, n_kv, dh, causal, dh_v)
    lib, lib_bwd = sdpa_grad_ms(q, k, v, do, causal)
    results[f"flash_attention_bwd.{tag}"] = r = dict(
        max_abs_err=err,
        ms=graph_ms(functools.partial(ops.flash_attention_bwd, q, k, v, o,
                                      do, lse, causal=causal), reps=5),
        plain_ms=eager_ms(functools.partial(
            ref.flash_attention_bwd_ref, q, k, v, o, do, lse,
            causal=causal), iters=2),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        library_bwd_ms=lib_bwd, shape=shape)
    print(f"[kernel] flash_attention_bwd.{tag}: kernel_ms {r['ms']:.4f} "
          f"plain_ms {r['plain_ms']:.4f} bound_ms {b_ms:.5f} ({b_by}) "
          f"library_ms {lib:.4f} (SDPA forward + backward) "
          f"library_bwd_ms {lib_bwd:.4f} (SDPA backward alone) | "
          f"{label} {shape}")
    del q, k, v, o, do, lse
    torch.cuda.empty_cache()


def phase_moe_train_kernels(results):
    """Phase 9a at the moe family's training shapes (MOE_FLASH_SHAPES):
    deepseek-v2-lite's MLA attention (H = n_kv = 16, dh 192 / dh_v 128,
    bf16 on the tensor cores; entries ``.mla``, whose launches phase 9i
    counts) and dbrx-132b's (48 query heads over 8 KV heads of 128: g = 6,
    which the dK / dV clusters of 4 ranks split 1, 2, 1, 2; entries
    ``.moe``); then (192, 128) in f32 on the CUDA-core path at the narrow
    model's T, at 2e-5."""
    import torch
    for tag, label, B, Tq, Tk, H, n_kv, dh, dh_v, causal in MOE_FLASH_SHAPES:
        flash_train_entry(results, tag, label, B, Tq, Tk, H, n_kv, dh, causal,
                          dh_v)
    train_kernel_case(2, NARROW_T, NARROW_T, 4, 4, 192, True, torch.float32,
                      2e-5, f"MLA widths f32 B=2 T={NARROW_T} H=n_kv=4 "
                      f"dh=192 dh_v=128", dh_v=128)


def reset_peak(dev):
    """Frees what the last phase left and restarts the card's memory
    high-water mark (nothing to do on the CPU)."""
    import torch
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def peak_gib(dev):
    """The card's memory high-water mark since ``reset_peak`` (0 on the
    CPU, which has none)."""
    import torch
    if torch.device(dev).type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated() / 2**30


def family_batch(cfg, B, T, step, n_frontend=0, seed=0):
    """Step ``step``'s batch: ``SyntheticLM``'s tokens (as the reference's
    Trainer draws them) and, for vlm and encdec, ``n_frontend`` frontend
    embeddings a row, N(0, 1) from a numpy seed (as
    tests/test_smoke_archs.py makes them)."""
    from repro_torch.data.pipeline import SyntheticLM
    batch = dict(SyntheticLM(cfg.vocab_size, T, B, seed=seed).batch_at(step))
    key = {"vlm": "patch_embeds", "encdec": "src_embeds"}.get(cfg.family)
    if key is not None:
        rng = np.random.default_rng([seed, step])
        batch[key] = rng.standard_normal((B, n_frontend, cfg.d_model),
                                         dtype=np.float32)
    return batch


def train_launches(cfg, steps, remat=True):
    """The training kernels' launches in ``steps`` steps of ``cfg``: per
    attention layer and step one flash forward with lse (two with remat,
    which recomputes it) and one backward; per Mamba-2 layer one SSD scan
    (two with remat) and one backward.  The hybrid stack recomputes
    nothing whatever ``remat`` says, as the reference's.  The flash calls
    by site as well (``flash_attention.train.<site>``,
    ``flash_attention_bwd.<site>``): encdec's encoder layers under
    ``encoder``, its cross-attention under ``cross_prefill``.  Per leaf
    and step one AdamW launch; no quantiser launch (no ``grad_compress``).
    """
    from repro_torch.models.hybrid import n_invocations
    attn, ssd = {"encdec": lambda: (cfg.encdec.enc_layers
                                    + 2 * cfg.encdec.dec_layers, 0),
                 "ssm": lambda: (0, cfg.n_layers),
                 "hybrid": lambda: (n_invocations(cfg), cfg.n_layers),
                 }.get(cfg.family, lambda: (cfg.n_layers, 0))()
    from repro_torch.kernels.flash_attention import SITES
    k = 2 if remat and cfg.family != "hybrid" else 1
    out = {"flash_attention.train": k * attn * steps,
           "flash_attention_bwd": attn * steps,
           "ssd_scan_bwd": ssd * steps, "ssd_scan": k * ssd * steps,
           "adamw": leaf_count(cfg) * steps, "grad_quant": 0}
    by_site = ({"encoder": cfg.encdec.enc_layers,
                "cross_prefill": cfg.encdec.dec_layers}
               if cfg.family == "encdec" else {})
    for site in SITES:
        out[f"flash_attention.train.{site}"] = k * by_site.get(site, 0) * steps
        out[f"flash_attention_bwd.{site}"] = by_site.get(site, 0) * steps
    return out


def read_train_counts():
    """The training kernels' counts, the flash ones also by site, and the
    SSD scan's, whose training forward is the serving call; and every
    other serving kernel's."""
    from repro_torch.kernels import ops
    serving = read_counts()
    return ({**ops.train_launch_counts(), **ops.train_site_counts(),
             "ssd_scan": serving.pop("ssd_scan")}, serving)


def check_family_training(cfg, label, log, counts, serving, steps, remat,
                          after, tokens, dev, extra=""):
    """What every phase of 9d-9g and 9i must show, on the card or (counts
    all 0) on the CPU: finite losses, MoE aux losses and grad norms, the
    aux above 0 where the model has MoE layers, the launches of
    ``train_launches`` and no serving kernel, and the final weights' loss
    on the last step's batch (``after``) below that batch's loss before its
    update.  Prints each step and a summary."""
    for r in log:
        print(f"[train:{label}] step {r['step']}: loss {r['loss']:.4f} "
              f"aux {r['aux']:.4f} grad_norm {r['grad_norm']:.4f} step_ms "
              f"{r['ms']:.1f} tokens/s {tokens / r['ms'] * 1e3:.0f}")
    require(len(log) == steps and all(
        np.isfinite([r["loss"], r["aux"], r["grad_norm"]]).all()
        for r in log), f"{label}: a loss, aux or grad norm is not finite: "
        f"{log}")
    require(cfg.moe is None or all(r["aux"] > 0 for r in log),
            f"{label}: a MoE model's load-balance aux is not above 0: {log}")
    want = train_launches(cfg, steps, remat)
    if dev == "cpu":
        want = dict.fromkeys(want, 0)
    require(counts == want and not any(serving.values()),
            f"{label}: launches {counts} (serving {serving}), not {want}")
    require(after < log[-1]["loss"],
            f"{label}: the final weights' loss on the last step's batch, "
            f"{after:.4f}, is not below its loss before the update, "
            f"{log[-1]['loss']:.4f}")
    steady = float(np.median([r["ms"] for r in log[1:]]))
    print(f"[train:{label}] {cfg.name}{extra} ({cfg.param_count() / 1e9:.3f} "
          f"G parameters, fp32 master weights, {cfg.dtype} compute): {steps} "
          f"steps, steps 2-{steps} median {steady:.1f} ms "
          f"({tokens / steady * 1e3:.0f} tokens/s); the final weights' loss "
          f"on step {steps}'s batch {after:.4f} < {log[-1]['loss']:.4f} "
          f"before its update; launches {counts}; peak memory "
          f"{peak_gib(dev):.2f} GiB ({SMI})")


def run_train_steps(lm, hp, batches, dev):
    """``len(batches)`` steps of ``make_train_step`` on ``lm``, launch
    counters reset just before; returns (log, counts, serving counts) with
    each step's loss, grad norm, MoE aux and host ms (until its loss was
    read)."""
    from repro_torch.kernels import ops
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.trainer import make_train_step
    step = make_train_step(lm, hp)
    opt = adamw_init(dict(lm.named_parameters()))
    log = []
    ops.reset_launch_counts()
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        opt, m = step(opt, batch)
        loss = float(m["loss"])
        log.append(dict(step=i + 1, loss=loss, grad_norm=float(m["grad_norm"]),
                        aux=float(m["aux"]),
                        ms=(time.perf_counter() - t0) * 1e3))
    counts, serving = read_train_counts()
    del opt
    return log, counts, serving


def phase_train_frontend(cfg, label, B, T, n_frontend, steps=FAMILY_STEPS,
                         dev="cuda", extra=""):
    """Phases 9d (encdec) and 9e (vlm): ``cfg`` from seed 0 trained
    ``steps`` steps through ``make_train_step`` on ``family_batch``es of B
    x T tokens with ``n_frontend`` frontend embeddings a row, remat block.
    Returns the training launch counts."""
    import torch
    from repro_torch.configs.base import TrainHParams
    from repro_torch.models.lm import LM
    reset_peak(dev)
    lm = LM(cfg, device=dev, master=True).init_weights(
        torch.Generator(device=dev).manual_seed(0))
    hp = TrainHParams(lr=3e-4, warmup_steps=1, total_steps=steps,
                      remat="block")
    batches = [family_batch(cfg, B, T, i, n_frontend) for i in range(steps)]
    log, counts, serving = run_train_steps(lm, hp, batches, dev)
    with torch.no_grad():
        after = float(lm.loss(batches[-1])[0])
    check_family_training(cfg, label, log, counts, serving, steps, True,
                          after, B * T, dev, extra)
    del lm, batches
    reset_peak(dev)
    return counts


def phase_train_recurrent(cfg, label, remat, B=TRAIN_B, T=TRAIN_T,
                          steps=FAMILY_STEPS, dev="cuda", extra=None):
    """Phases 9f (ssm), 9g (hybrid) and 9i (moe): ``Trainer`` on
    ``SyntheticLM`` at B x T from seed 0, ``remat`` as given (the hybrid
    stack recomputes nothing whatever it says); ``extra`` describes the
    model (default: at its published width and depth).  Returns the launch
    counts."""
    import torch
    from repro_torch.configs.base import TrainHParams
    from repro_torch.kernels import ops
    from repro_torch.train.trainer import Trainer
    reset_peak(dev)
    hp = TrainHParams(lr=3e-4, warmup_steps=1, total_steps=steps,
                      remat=remat)
    tr = Trainer(cfg, hp, batch_per_step=B, seq_len=T, seed=0, device=dev)
    ops.reset_launch_counts()
    tr.run(steps, log_every=1)
    counts, serving = read_train_counts()
    with torch.no_grad():
        after = float(tr.lm.loss(tr.data.batch_at(steps - 1))[0])
    check_family_training(cfg, label, tr.log, counts, serving, steps,
                          remat != "none", after, B * T, dev,
                          (extra or " at its published width and depth")
                          + f", remat {remat}")
    del tr
    reset_peak(dev)
    return counts


def narrow_train_config(arch):
    """Phase 9h's narrow f32 model of ``arch``'s family: ``narrow_config``'s
    widths at 2 layers (encdec 2 + 2 over NARROW_T source frames; vlm with
    64 image tokens; hybrid 3 Mamba-2 layers with the shared block after
    the first two, so that it also runs a tail)."""
    from repro_torch.configs import get_config
    cfg = narrow_config(get_config(arch))
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, encdec=dataclasses.replace(
            cfg.encdec, enc_layers=2, dec_layers=2, source_len=NARROW_T))
    elif cfg.family == "vlm":
        cfg = dataclasses.replace(cfg, frontend_tokens=64)
    elif cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=3, hybrid=dataclasses.replace(
            cfg.hybrid, period=2))
    return cfg


def family_train_agreement(arch, dev="cuda", steps=FAMILY_STEPS, cfg=None):
    """Phase 9h for one family: the narrow f32 model (``cfg``, default
    ``narrow_train_config(arch)``) trained ``steps`` steps through
    ``make_train_step`` (remat block) on ``dev`` (the card; the CPU
    rehearses it) and on the CPU from the same weights: every step's loss
    and the first step's grad norm within 1e-4 relative, and on the card
    the launches of ``train_launches``.  A MoE model's CPU run takes the
    card's expert choices (``ExpertChoices``; forward and recompute alike),
    and at least 90 % of the tokens must get the same experts from both."""
    import torch
    from repro_torch.configs.base import TrainHParams
    from repro_torch.models.lm import LM
    cfg = narrow_train_config(arch) if cfg is None else cfg
    n_front = (cfg.frontend_tokens if cfg.family == "vlm" else
               cfg.encdec.source_len if cfg.family == "encdec" else 0)
    hp = TrainHParams(lr=1e-3, warmup_steps=1, total_steps=steps,
                      remat="block")
    batches = [family_batch(cfg, 2, NARROW_T, i, n_front)
               for i in range(steps)]
    card = LM(cfg, device=dev, master=True).init_weights(
        torch.Generator(device=dev).manual_seed(0))
    cpu = LM(cfg, master=True)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    experts = ExpertChoices()
    runs = [experts.run(hook, run_train_steps, lm, hp, batches, d)
            for lm, d, hook in ((card, dev, experts.record),
                                (cpu, "cpu", experts.replay))]
    (log_c, counts, serving), (log_p, _, _) = runs
    agree, n_routed = experts.share()
    require(agree >= 0.9, f"narrow {arch} training: the two devices route "
            f"only {agree:.1%} of {n_routed} tokens to the same experts")
    for a, b in zip(log_c, log_p):
        # The first step's grad norm too: later ones follow AdamW updates,
        # whose m / sqrt(v) turns the two devices' last-bit differences in
        # small gradients into whole learning-rate steps.
        for key in ("loss", "grad_norm") if a["step"] == 1 else ("loss",):
            require(abs(a[key] - b[key]) <= 1e-4 * abs(b[key]),
                    f"narrow {arch} training: card {key} {a[key]} != CPU "
                    f"{key} {b[key]} at step {a['step']}")
    want = train_launches(cfg, steps) if dev == "cuda" else dict.fromkeys(
        counts, 0)
    require(counts == want and not any(serving.values()),
            f"narrow {arch} training: launches {counts} (serving "
            f"{serving}), not {want}")
    routed = (f"; the CPU took the {dev}'s expert choices, its own the same "
              f"for {agree:.1%} of {n_routed} routed tokens"
              if n_routed else "")
    print(f"[train:agreement:{cfg.family}] narrow f32 {arch}, same weights, "
          f"{steps} steps: {dev} losses "
          f"{[round(r['loss'], 6) for r in log_c]} within 1e-4 of the "
          f"CPU's {[round(r['loss'], 6) for r in log_p]}, step 1's grad "
          f"norm {log_c[0]['grad_norm']:.6f} too{routed}; launches {counts}")


def phase_train_families(counts):
    """Phases 9d-9i; adds each phase's launches to ``counts`` under the
    kernels line's entries (by shape, see ``train_entries``), and their
    AdamW launches to ``adamw``'s."""
    import torch
    from repro_torch.configs import get_config
    enc = get_config(ENCDEC_ARCH)
    vlm = dataclasses.replace(get_config(VLM_ARCH),
                              n_layers=VLM_TRAIN_LAYERS)
    runs = {
        "encdec": phase_train_frontend(enc, "encdec", ENCDEC_TRAIN_B,
                                       ENCDEC_TRAIN_T, ENCDEC_SRC,
                                       extra=" at its published width and "
                                       "depth, remat block"),
        "vlm": phase_train_frontend(vlm, "vlm", 1, VLM_TRAIN_T, VLM_TRAIN_P,
                                    extra=f" at its published widths, "
                                    f"reduced: depth 32 -> "
                                    f"{VLM_TRAIN_LAYERS} layers, remat "
                                    f"block"),
        "ssm": phase_train_recurrent(get_config(SSM_ARCH), "ssm", "block"),
        "hybrid": phase_train_recurrent(get_config(HYBRID_ARCH), "hybrid",
                                        "block"),
    }
    for arch in (ENCDEC_ARCH, VLM_ARCH, SSM_ARCH, HYBRID_ARCH, MLA_ARCH,
                 MOE_ARCH):
        family_train_agreement(arch)
    torch.cuda.empty_cache()
    for k, n in train_entries(runs).items():
        counts[k] = counts.get(k, 0) + n
    moe = phase_train_moe()
    counts.update(moe_entries(moe))
    counts["adamw"] = counts.get("adamw", 0) + sum(
        r["adamw"] for r in (*runs.values(), moe))


def phase_train_moe(dev="cuda", cfg=None, B=TRAIN_B, T=TRAIN_T):
    """Phase 9i: deepseek-v2-lite (``cfg``, default its published widths,
    reduced: depth 27 -> MOE_TRAIN_LAYERS, the dense layer and 4 MoE)
    trained FAMILY_STEPS steps by ``Trainer`` on ``SyntheticLM`` at B x T
    from seed 0, remat block: ``check_family_training``'s checks (aux above
    0; per layer and step two flash forwards with lse and one backward, at
    dh 192 / dh_v 128).  Returns the launch counts."""
    from repro_torch.configs import get_config
    full = get_config(MLA_ARCH)
    if cfg is None:
        cfg = dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS)
    return phase_train_recurrent(
        cfg, "moe", "block", B=B, T=T, dev=dev,
        extra=f" at its published widths, reduced: depth {full.n_layers} -> "
              f"{cfg.n_layers} layers (the dense one and "
              f"{cfg.n_layers - cfg.moe.first_dense} MoE)")


def moe_entries(counts):
    """The kernels line's launches of the moe family's entries: phase 9i's
    flash forwards with lse and backwards at the MLA shape (``.mla``), and
    none at dbrx's (``.moe``, ZERO_LAUNCHES)."""
    out = dict.fromkeys(ZERO_LAUNCHES, 0)
    for kern in ("flash_attention.train", "flash_attention_bwd"):
        out[f"{kern}.mla"] = counts[kern]
    return out


def train_entries(runs):
    """The kernels line's launches from phases 9d-9g, each as its phase's
    wrappers counted it and at the shape its entry times: the flash
    forward with lse and the backward of llava (``.vlm``) and of zamba2's
    shared block (``.hybrid``); seamless's by site, the encoder's
    (``.encoder``), the cross-attention's (``.cross``, site
    ``cross_prefill``) and the rest, its decoder's self-attention
    (``.decoder``); the SSD scan's training forward (``ssd_scan.train``)
    and backward (``ssd_scan_bwd``) of mamba2, and zamba2's
    (``.hybrid``)."""
    enc = runs["encdec"]
    out = {}
    for kern in ("flash_attention.train", "flash_attention_bwd"):
        out[f"{kern}.vlm"] = runs["vlm"][kern]
        out[f"{kern}.hybrid"] = runs["hybrid"][kern]
        out[f"{kern}.encoder"] = enc[f"{kern}.encoder"]
        out[f"{kern}.cross"] = enc[f"{kern}.cross_prefill"]
        out[f"{kern}.decoder"] = (enc[kern] - enc[f"{kern}.encoder"]
                                  - enc[f"{kern}.cross_prefill"])
    for kern in ("ssd_scan.train", "ssd_scan_bwd"):
        key = kern.split(".")[0]
        out[kern] = runs["ssm"][key]
        out[f"{kern}.hybrid"] = runs["hybrid"][key]
    return out


def family_entries(vlm, encdec, dense):
    """Launch counts of the kernels line's entries from phases 4g-4i, each
    at the shapes its entry times: llava's prefill flash
    (``flash_attention.vlm``), the g = 4 / dh 128 paged calls of llava,
    llama3 and qwen3 and llava's fused calls (``.g4d128``), phi3's flash
    and paged calls (``.phi3``, ``.g1d96``), seamless's fused calls
    (``.g1d64``) and its flash calls by site (``flash_attention.encoder``,
    ``.cross_prefill``, ``.cross_decode``, as the wrapper counted them).
    Every other launch of those phases counts under its kernel's own
    entry."""
    sites = ("flash_attention.encoder", "flash_attention.cross_prefill",
             "flash_attention.cross_decode")
    tagged = {
        "flash_attention.vlm": vlm.pop("flash_attention"),
        "paged_attention.page.g4d128": vlm.pop("paged_attention.page"),
        "paged_attention.frame.g4d128": vlm.pop("paged_attention.frame"),
        "paged_attention.fused.g4d128": vlm.pop("paged_attention.fused"),
        "flash_attention.phi3": dense["phi3-mini-3.8b"].pop(
            "flash_attention"),
        "paged_attention.page.g1d96": dense["phi3-mini-3.8b"].pop(
            "paged_attention.page"),
        "paged_attention.fused.g1d64": encdec.pop("paged_attention.fused"),
    }
    for k in sites:
        tagged[k] = encdec.pop(k)
        encdec["flash_attention"] -= tagged[k]
    for arch in ("llama3-8b", "qwen3-8b"):
        tagged["paged_attention.page.g4d128"] += dense[arch].pop(
            "paged_attention.page")
    rest = {}
    for c in [vlm, encdec, *dense.values()]:
        for k, n in c.items():
            if k not in sites:
                rest[k] = rest.get(k, 0) + n
    return tagged, rest


# ------------------------------------------------ data-parallel training

DIST_STEPS = 3          # phase 9j (a): full-width qwen2.5-3b steps
DIST_NARROW_STEPS = 4   # phase 9j (b), (c): the narrow model's steps


def narrow_dist_weights(cfg):
    """The narrow model's fp32 weights from a CPU generator at seed 0:
    the same numbers in every process of phase 9j, card or CPU."""
    import torch
    from repro_torch.models.lm import LM
    lm = LM(cfg, master=True).init_weights(torch.Generator().manual_seed(0))
    return {k: v.detach() for k, v in lm.state_dict().items()}


def narrow_dist_trainer(parallelism, compress, dev, mesh, ckpt_dir=None,
                        resume=False):
    """``Trainer`` of the narrow model over ``mesh`` (this group's ranks),
    B 2 x NARROW_T, remat block, from ``narrow_dist_weights``; checkpoints
    every 2 steps into ``ckpt_dir`` unless it resumes from there."""
    from repro_torch.configs.base import TrainHParams
    from repro_torch.train.trainer import Trainer
    cfg = narrow_train_config(ARCH)
    hp = TrainHParams(lr=1e-3, warmup_steps=1, total_steps=DIST_NARROW_STEPS,
                      remat="block", parallelism=parallelism,
                      grad_compress=compress)
    return Trainer(cfg, hp, batch_per_step=2, seq_len=NARROW_T, mesh=mesh,
                   device=dev, ckpt_dir=ckpt_dir,
                   ckpt_every=0 if resume or not ckpt_dir else 2,
                   resume=resume, params=narrow_dist_weights(cfg))


def dist_rank(case):
    """Phase 9j's work on one rank of a group that ``run_ranks`` started
    (NCCL on the card, gloo on the CPU).  ``case["part"]``:

    * ``full``: (a) ``case["arch"]`` (the smoke config on the CPU) through
      ``Trainer`` on ``make_host_mesh()``, megatron + ZeRO-1 +
      ``grad_compress``, remat block, B x T, DIST_STEPS steps, with the
      training kernels' launches; then the final weights' loss on the last
      step's batch;
    * ``narrow``: (b) the narrow model on ``make_host_mesh()`` under
      megatron + ``grad_compress`` (checkpoints into ``case["ckpt_dir"]``)
      and under fsdp, DIST_NARROW_STEPS steps each, and the launches of
      both runs;
    * ``reshard``: (c) that megatron + ``grad_compress`` run resumed from
      the step-2 checkpoint in ``case["ckpt_dir"]`` on this group's ranks,
      all data-parallel (``make_elastic_mesh(world, model=1)``): its
      restored state gathered to full arrays, then the remaining steps."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import TrainHParams
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_elastic_mesh, make_host_mesh
    from repro_torch.train.trainer import Trainer
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if dev == "cpu":
        torch.set_num_threads(2)
    if case["part"] == "full":
        cfg = (get_config if case["width"] == "full" else get_smoke_config)(
            case["arch"])
        hp = TrainHParams(lr=3e-4, warmup_steps=2, total_steps=DIST_STEPS,
                          remat="block", grad_compress=True)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = Trainer(cfg, hp, batch_per_step=case["B"], seq_len=case["T"],
                     mesh=make_host_mesh(), seed=0, device=dev)
        t_init = time.perf_counter() - t0
        ops.reset_launch_counts()
        tr.run(DIST_STEPS, log_every=1)
        launches = ops.train_launch_counts()
        with torch.no_grad():
            after = float(tr.lm.loss(tr.data.batch_at(DIST_STEPS - 1))[0])
        mem = {"peak": 0.0, "reserved": 0.0, "retries": 0}
        if dev == "cuda":
            mem = {"peak": torch.cuda.max_memory_allocated() / 2**30,
                   "reserved": torch.cuda.max_memory_reserved() / 2**30,
                   "retries": torch.cuda.memory_stats()["num_alloc_retries"]}
        return {"log": tr.log, "after": after, "t_init": t_init,
                "mesh": str(tr.mesh.shape), "params": cfg.param_count(),
                "leaves": leaf_count(cfg), "launches": launches, **mem}
    if case["part"] == "narrow":
        out = {}
        ops.reset_launch_counts()
        for name, compress, d in (("megatron", True, case["ckpt_dir"]),
                                  ("fsdp", False, None)):
            tr = narrow_dist_trainer(name, compress, dev, make_host_mesh(),
                                     ckpt_dir=d)
            tr.run(DIST_NARROW_STEPS, log_every=1)
            out[name] = [r["loss"] for r in tr.log]
            del tr
        out["launches"] = ops.train_launch_counts()
        return out
    tr = narrow_dist_trainer("megatron", True, dev,
                             make_elastic_mesh(dist.get_world_size(),
                                               model=1),
                             ckpt_dir=case["ckpt_dir"], resume=True)
    st = tr.step_fn
    state = {"start": tr.start_step,
             "sharded": sum(p.sharded for p in st.places.values()),
             "params": {n: st.param_places[n].gather(t.detach().contiguous())
                        for n, t in tr.params.items()},
             # f32 master elements this rank holds, of data-split leaves
             # and of the whole model: (held, full, data ranks) per leaf
             "masters": {n: (t.numel(), math.prod(st.param_places[n].shape),
                             st.param_places[n].data.n
                             if st.param_places[n].data else 1)
                         for n, t in tr.params.items()}}
    for part in ("mu", "nu"):
        state[part] = {n: st.places[n].gather(t)
                       for n, t in tr.opt[part].items()}
    tr.run(DIST_NARROW_STEPS - tr.start_step, log_every=1)
    state["losses"] = [r["loss"] for r in tr.log]
    return state


def _saved_arrays(step_dir):
    """{path: array} of a checkpoint directory."""
    meta = json.loads((step_dir / "meta.json").read_text())
    return {l["path"]: np.load(step_dir / "arrays" / f"{l['idx']}.npy")
            for l in meta["leaves"]}


def phase_train_dist(dev="cuda"):
    """Phase 9j: data-parallel training through the distributed code, each
    part on ranks that ``run_ranks`` starts (rendezvous through a
    ``FileStore`` in a temporary directory).  On the card one rank over
    NCCL; ``dev="cpu"`` rehearses it on gloo ranks with the smoke config
    in (a).

    (a) full-width qwen2.5-3b, megatron + ZeRO-1 + ``grad_compress``:
        step ms, tokens/s and peak GiB; the final weights' loss on the last
        step's batch below that batch's loss before the update;
    (b) the narrow f32 model under megatron + ``grad_compress`` and under
        fsdp, on ``dev``'s rank and on a gloo rank: losses within 1e-4;
    (c) ``dev``'s world-1 step-2 checkpoint of (b) resumed on 2 gloo ranks:
        the restored state bit for bit the saved arrays, each rank holding
        half the f32 master elements of every data-split leaf (ZeRO-1),
        the next losses within 1e-4 of (b)'s CPU run.

    Returns the AdamW and quantiser launches of (a) and (b) on ``dev``'s
    rank."""
    import tempfile
    import torch
    from repro_torch.launch.spawn import run_ranks
    held = 0.0
    if dev == "cuda":       # the ranks' processes need the card's memory
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved() / 2**30
    full = dict(part="full", arch=ARCH, width="full", B=TRAIN_B, T=TRAIN_T)
    if dev == "cpu":
        full.update(width="smoke", B=2, T=64)
    tmp = Path(tempfile.mkdtemp(prefix="dist_ckpt_"))
    try:
        # Expandable segments: the full-width rank peaks at ~64 GiB of
        # tensors, which the default allocator's fragmentation takes to
        # ~76 GiB reserved, beside this process's own context.
        run = functools.partial(
            run_ranks, "chip_smoke:dist_rank", paths=[str(ROOT)],
            timeout=600, env=dict(
                os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))
        card = run(1, device=dev, args=[full])[0]
        log = card["log"]
        tokens = full["B"] * full["T"]
        steady = float(np.median([r["ms"] for r in log[1:]]))
        for r in log:
            print(f"[train:dist] step {r['step']}: loss {r['loss']:.4f} "
                  f"grad_norm {r['grad_norm']:.4f} step_ms {r['ms']:.1f} "
                  f"tokens/s {tokens / r['ms'] * 1e3:.0f}")
        losses = [r["loss"] for r in log]
        require(all(np.isfinite([r["loss"], r["grad_norm"]]).all()
                    for r in log), f"9j (a): a loss or grad norm is not "
                f"finite: {log}")
        require(card["after"] < losses[-1],
                f"9j (a): the final weights' loss on the last step's batch, "
                f"{card['after']:.4f}, is not below its loss before the "
                f"update, {losses[-1]:.4f}")
        # One rank: per leaf and step one quantiser pass (Q(g + e), no
        # ring) and one AdamW launch; none counted on the CPU.
        per = card["leaves"] * DIST_STEPS if dev == "cuda" else 0
        got = {k: card["launches"][k] for k in ("adamw", "grad_quant")}
        require(got == {"adamw": per, "grad_quant": per},
                f"9j (a): launches {got}, not {per} of each (one per leaf "
                f"and step)")
        print(f"[train:dist] {full['arch']} ({full['width']} width, "
              f"{card['params'] / 1e9:.3f} G parameters) on mesh "
              f"{card['mesh']} over one {dev} rank, megatron + ZeRO-1 + "
              f"grad_compress, remat block, batch {full['B']} x seq "
              f"{full['T']}: {DIST_STEPS} steps after {card['t_init']:.1f}s "
              f"of set-up; steps 2-{DIST_STEPS} median {steady:.1f} ms "
              f"({tokens / steady * 1e3:.0f} tokens/s); loss {losses[0]:.4f} "
              f"-> {losses[-1]:.4f}, on step {DIST_STEPS}'s batch after its "
              f"update {card['after']:.4f}; peak memory {card['peak']:.2f} "
              f"GiB ({card['reserved']:.2f} reserved, {card['retries']} "
              f"allocator retries; this process held "
              f"{held:.2f} GiB); launches {card['launches']} ({SMI})")
        case = dict(part="narrow", ckpt_dir=str(tmp / "world1"))
        on_dev = run(1, device=dev, args=[case])[0]
        on_cpu = run(1, device="cpu",
                     args=[dict(case, ckpt_dir=str(tmp / "cpu"))])[0]
        launches = {k: card["launches"][k] + on_dev["launches"][k]
                    for k in ("adamw", "grad_quant")}
        for name in ("megatron", "fsdp"):
            a, b = on_dev[name], on_cpu[name]
            require(all(abs(x - y) <= 1e-4 * abs(y) for x, y in zip(a, b)),
                    f"9j (b) {name}: {dev} losses {a} off the CPU's {b}")
            print(f"[train:dist:agreement] narrow f32 {ARCH}, {name}"
                  f"{' + grad_compress' if name == 'megatron' else ''}, "
                  f"{dev} rank {[round(x, 6) for x in a]} within 1e-4 of "
                  f"the CPU rank's {[round(x, 6) for x in b]}")
        # The step-2 checkpoint alone: resume takes the newest one.
        step2 = Path(case["ckpt_dir"]) / "step_00000002"
        shutil.copytree(step2, tmp / "reshard" / step2.name)
        res = run(2, device="cpu", args=[dict(part="reshard",
                                              ckpt_dir=str(tmp / "reshard"))])
        saved = _saved_arrays(step2)
        for r, got in enumerate(res):
            require(got["start"] == 2 and got["sharded"] > 0,
                    f"9j (c): rank {r} resumed at {got['start']} with "
                    f"{got['sharded']} sharded leaves")
            for part, prefix in (("params", "params/"), ("mu", "opt/mu/"),
                                 ("nu", "opt/nu/")):
                for n, t in got[part].items():
                    require(np.array_equal(t.numpy(), saved[prefix + n]),
                            f"9j (c): rank {r}'s restored {prefix}{n} "
                            f"differs from the saved array")
            # ZeRO-1 keeps each f32 master at its data shard: half of every
            # leaf that zero1_specs splits over the 2 data ranks.
            split = {n: m for n, m in got["masters"].items() if m[2] > 1}
            require(split and all(m[2] == 2 and 2 * m[0] == m[1]
                                  for m in split.values()),
                    f"9j (c): rank {r} does not hold half of each "
                    f"data-split f32 master: {split}")
            held = sum(m[0] for m in split.values())
            whole = sum(m[1] for m in split.values())
            print(f"[train:dist:zero1] rank {r}: {len(split)} of "
                  f"{len(got['masters'])} leaves split over data, "
                  f"{held} of their {whole} f32 master elements held; "
                  f"{sum(m[0] for m in got['masters'].values())} of the "
                  f"model's {sum(m[1] for m in got['masters'].values())}")
            want = on_cpu["megatron"][2:]
            require(all(abs(x - y) <= 1e-4 * abs(y)
                        for x, y in zip(got["losses"], want)),
                    f"9j (c): rank {r}'s losses {got['losses']} off the "
                    f"world-1 CPU run's {want}")
        print(f"[train:dist:reshard] the {dev} rank's step-2 checkpoint "
              f"resumed on 2 gloo ranks ({res[0]['sharded']} leaves' "
              f"moments sharded): state bit for bit the saved arrays; "
              f"losses {[round(x, 6) for x in res[0]['losses']]} within "
              f"1e-4 of the world-1 CPU run's "
              f"{[round(x, 6) for x in on_cpu['megatron'][2:]]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ------------------------------------------ tensor / expert parallelism

TP_LAYERS = 18          # phase 9k (a): qwen2.5-3b's first 18 of 36 layers:
#                         each of two ranks sharing the card holds ~22 GB
#                         of training state (all 36: ~72 GB for the two)
TP_STEPS = 2            # phase 9k (a): the script stays near half its limit
TP_MESH = (1, 2)        # (data, model)
TP_ARCHS = (ARCH, "qwen3-8b", MOE_ARCH, MLA_ARCH)   # phase 9k (b)
# Phase 9a's rows at qwen2.5-3b's tp = 2 shard: 8 query heads over 1 KV
# head of 128 (entries ``.tp``, launches from 9k (a)).
TP_FLASH_SHAPE = ("tp", "qwen2.5-3b's tp = 2 shard", TRAIN_B, TRAIN_T,
                  TRAIN_T, 8, 1, 128, True)


def phase_tp_kernels(results):
    """Phase 9a at a tensor-parallel shard's head counts: the flash forward
    with lse and the backward at TP_FLASH_SHAPE, timed beside their bounds
    and SDPA's (``flash_attention.train.tp``, ``flash_attention_bwd.tp``).
    With one KV head and B 2 the backward's dK / dV step has 2 x 32 key
    tiles x 4 cluster ranks = 256 CTAs and its dQ step 2 x 256 row tiles:
    under two waves of 132 SMs each."""
    tag, label, B, Tq, Tk, H, n_kv, dh, causal = TP_FLASH_SHAPE
    flash_train_entry(results, tag, label, B, Tq, Tk, H, n_kv, dh, causal)


def narrow_tp_config(arch):
    """Phase 9k (b)'s f32 model of ``arch``: ``narrow_train_config``'s
    (head dim 32, or the architecture's own 128 and MLA's 192 / 128: the
    widths the card's kernels take; the smoke configs' 8-24 are not), with
    the smoke config's MoE (4 experts: 2 a rank at tp = 2)."""
    from repro_torch.configs import get_smoke_config
    cfg = narrow_train_config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=get_smoke_config(arch).moe)
    return cfg


class ModelCollectives:
    """Counts, while active, the all-reduces over ``group`` (the model
    axis) by kind: ``reduce`` (reduce-from-model, forward), ``copy``
    (copy-to-model, backward), ``other`` (the rest, e.g. the grad norm's
    when the mesh is the model axis), and the all-gathers over it
    (``gather``: the gathered leaves)."""

    def __init__(self, group):
        from repro_torch.models import common
        self.group, self.common = group, common
        self.counts = dict(reduce=0, copy=0, other=0, gather=0)

    def __enter__(self):
        import torch.distributed as dist
        c, self.dist = self.common, dist
        self.saved = (c._ReduceFromModel.forward, c._CopyToModel.backward,
                      dist.all_reduce, dist.all_gather_into_tensor)
        fwd, bwd, ar, ag = self.saved
        kind = [None]

        def tagged(name, fn):
            def run(ctx, *args):
                kind[0] = name
                try:
                    return fn(ctx, *args)
                finally:
                    kind[0] = None
            return staticmethod(run)

        def all_reduce(t, *a, group=None, **kw):
            if group is self.group:
                self.counts[kind[0] or "other"] += 1
            return ar(t, *a, group=group, **kw)

        def all_gather(out, t, *a, group=None, **kw):
            self.counts["gather"] += group is self.group
            return ag(out, t, *a, group=group, **kw)
        c._ReduceFromModel.forward = tagged("reduce", fwd)
        c._CopyToModel.backward = tagged("copy", bwd)
        dist.all_reduce, dist.all_gather_into_tensor = all_reduce, all_gather
        return self

    def __exit__(self, *exc):
        c = self.common
        c._ReduceFromModel.forward = staticmethod(self.saved[0])
        c._CopyToModel.backward = staticmethod(self.saved[1])
        self.dist.all_reduce, self.dist.all_gather_into_tensor = \
            self.saved[2:]


def tp_trainer(arch, dev, mesh, ckpt_dir=None, resume=False):
    """``Trainer`` of ``narrow_tp_config(arch)`` over ``mesh`` (this group's
    ranks), megatron, B 2 x NARROW_T, remat block, from
    ``narrow_dist_weights``; checkpoints every 2 steps into ``ckpt_dir``
    unless it resumes from there."""
    from repro_torch.configs.base import TrainHParams
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train.trainer import Trainer
    cfg = narrow_tp_config(arch)
    hp = TrainHParams(lr=1e-3, warmup_steps=1, total_steps=DIST_NARROW_STEPS,
                      remat="block")
    return Trainer(cfg, hp, batch_per_step=2, seq_len=NARROW_T,
                   mesh=Mesh(mesh, ("data", "model")), device=dev,
                   ckpt_dir=ckpt_dir,
                   ckpt_every=0 if resume or not ckpt_dir else 2,
                   resume=resume, params=narrow_dist_weights(cfg))


def tp_full_run(case):
    """Phase 9k (a) on this process's ranks of ``case["mesh"]`` (a (1, 1)
    mesh needs no process group): see ``tp_rank``'s ``full``."""
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import TrainHParams
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train.trainer import Trainer
    dev = case["device"]
    cfg = (get_config if case["width"] == "full" else get_smoke_config)(ARCH)
    cfg = dataclasses.replace(cfg, n_layers=case["layers"])
    hp = TrainHParams(lr=3e-4, warmup_steps=2, total_steps=TP_STEPS,
                      remat="save_collectives")
    reset_peak(dev)
    t0 = time.perf_counter()
    tr = Trainer(cfg, hp, batch_per_step=case["B"], seq_len=case["T"],
                 mesh=Mesh(case["mesh"], ("data", "model")), seed=0,
                 device=dev)
    t_init = time.perf_counter() - t0
    ops.reset_launch_counts()
    group = tr.step_fn.par.model_group
    coll = (ModelCollectives(group) if group is not None
            else contextlib.nullcontext())
    with coll:
        tr.run(TP_STEPS, log_every=1)
    launches = ops.train_launch_counts()
    after = tr.step_fn.loss(tr.data.batch_at(TP_STEPS - 1))
    mem = {"peak": peak_gib(dev), "reserved": 0.0}
    if torch.device(dev).type == "cuda":
        mem["reserved"] = torch.cuda.max_memory_reserved() / 2**30
    return {"log": tr.log, "after": after, "t_init": t_init,
            "collectives": getattr(coll, "counts", None),
            "launches": launches, "params": cfg.param_count(), **mem}


def tp_rank(case):
    """Phase 9k's work on one rank of a gloo group that ``run_ranks``
    started, on ``case["device"]`` (the card: every rank on cuda:0).
    ``case["part"]``:

    * ``full``: (a) qwen2.5-3b (``case["width"]``: its published widths,
      or the smoke config on the CPU) cut to ``case["layers"]`` layers,
      ``Trainer`` over ``case["mesh"]``, megatron, remat
      "save_collectives", B x T, TP_STEPS steps: the log, the all-reduces
      over ``model`` by kind (``ModelCollectives``), the training kernels'
      launches, the final weights' loss on the last step's batch, memory;
    * ``narrow``: (b) ``narrow_tp_config(arch)`` of each arch of
      ``case["archs"]`` over ``case["mesh"]`` for DIST_NARROW_STEPS steps
      (checkpoints into ``case["ckpt_dir"][arch]`` if given): {arch: its
      losses and MoE aux}; a MoE model's expert choices recorded
      (``case["choices"]`` None) or replayed from the file
      ``case["choices"][arch]`` (``ExpertChoices``);
    * ``reshard``: (c) that checkpoint restored over ``case["mesh"]``: its
      state gathered to full arrays, then the remaining steps' losses."""
    import torch
    dev = case["device"]
    if dev == "cpu":
        torch.set_num_threads(2)
    if case["part"] == "full":
        return tp_full_run(case)
    if case["part"] == "narrow":
        outs = {}
        for arch in case["archs"]:
            experts = ExpertChoices()
            hook = experts.record
            replay = (case.get("choices") or {}).get(arch)
            if replay:
                experts.choices = torch.load(replay, weights_only=True)
                hook = experts.replay
            tr = tp_trainer(arch, dev, case["mesh"],
                            ckpt_dir=case.get("ckpt_dir", {}).get(arch))
            experts.run(hook, tr.run, DIST_NARROW_STEPS, log_every=1)
            out = outs[arch] = {"loss": [r["loss"] for r in tr.log],
                                "aux": [r["aux"] for r in tr.log]}
            if replay:
                out["routed_alike"] = experts.share()[0]
            else:
                out["choices"] = [c.cpu() for c in experts.choices]
            del tr
        return outs
    tr = tp_trainer(ARCH, dev, case["mesh"], ckpt_dir=case["ckpt_dir"],
                    resume=True)
    st = tr.step_fn
    state = {"start": tr.start_step,
             "sharded": sum(p.sharded for p in st.places.values()),
             "params": {n: st.param_places[n].gather(
                 t.detach().contiguous()).clone()
                 for n, t in tr.params.items()}}
    for part in ("mu", "nu"):       # copies: the steps below update them
        state[part] = {n: st.places[n].gather(t).clone()
                       for n, t in tr.opt[part].items()}
    tr.run(DIST_NARROW_STEPS - tr.start_step, log_every=1)
    state["losses"] = [r["loss"] for r in tr.log]
    return state


def phase_train_tp(dev="cuda"):
    """Phase 9k: tensor and expert parallelism over a ``model`` axis of 2,
    in gloo ranks that ``run_ranks`` starts; on the card both ranks of a
    group share cuda:0 (NCCL cannot put two ranks on one GPU), so their
    step times are two ranks time-sharing one card, not a TP speed.
    ``dev="cpu"`` rehearses it on gloo CPU ranks (the smoke config in (a)).

    (a) qwen2.5-3b at its published widths, reduced: depth 36 -> TP_LAYERS,
        megatron, remat "save_collectives", TRAIN_B x TRAIN_T, TP_STEPS
        steps, on one rank (mesh (1, 1)) and on two (TP_MESH): step ms,
        tokens/s and peak GiB per rank; per step 4 all-reduces over
        ``model`` a layer (2 reduces forward, 2 copies backward) and none
        for the gathered leaves (all-gathers, whose backward takes the
        rank's chunk); step 1's loss within 5e-3 relative of the one-rank
        run's (bf16 partial sums); the last step's batch scores lower after
        its update.  Returns the launches of the flash kernels at the tp
        shard (TP_FLASH_SHAPE's entries: both ranks' calls);
    (b) TP_ARCHS' f32 models (``narrow_tp_config``; EP at 4 experts, 2 a
        rank; MLA gathered) at TP_MESH on ``dev``'s ranks and on gloo CPU
        ranks (a MoE model's CPU run replaying the card's expert choices):
        losses within 1e-4;
    (c) (b)'s qwen2.5-3b step-2 checkpoint at TP_MESH resumed on 2 gloo CPU
        ranks at (2, 1): the restored state bit for bit the saved arrays,
        the next losses within 1e-4 of (b)'s CPU run's."""
    import tempfile
    import torch
    from repro_torch.launch.spawn import run_ranks
    held = 0.0
    if dev == "cuda":       # the ranks' processes need the card's memory
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved() / 2**30
    full = dict(part="full", width="full", layers=TP_LAYERS, B=TRAIN_B,
                T=TRAIN_T, device=dev)
    if dev == "cpu":
        full.update(width="smoke", layers=2, B=2, T=64)
    tmp = Path(tempfile.mkdtemp(prefix="tp_ckpt_"))
    run = functools.partial(
        run_ranks, "chip_smoke:tp_rank", paths=[str(ROOT)], timeout=600,
        backend="gloo", env=dict(
            os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))
    t0 = time.perf_counter()
    try:
        one = tp_full_run(dict(full, mesh=[1, 1]))     # in this process
        reset_peak(dev)
        t_one = time.perf_counter()
        two = run(2, device=dev, args=[dict(full, mesh=list(TP_MESH))])
        t_two = time.perf_counter()
        tokens = full["B"] * full["T"]
        L = full["layers"]
        for label, ranks in (("(1, 1)", [one]), (str(TP_MESH), two)):
            for r, out in enumerate(ranks):
                log = out["log"]
                require(all(np.isfinite([x["loss"], x["grad_norm"]]).all()
                            for x in log), f"9k (a) {label}: a loss or grad "
                        f"norm is not finite: {log}")
                require(out["after"] < log[-1]["loss"],
                        f"9k (a) {label} rank {r}: the final weights' loss "
                        f"on the last step's batch, {out['after']:.4f}, is "
                        f"not below its loss before the update, "
                        f"{log[-1]['loss']:.4f}")
                steady = float(np.median([x["ms"] for x in log[1:]]))
                print(f"[train:tp] {ARCH} ({full['width']} width, "
                      f"{out['params'] / 1e9:.3f} G parameters, reduced: "
                      f"depth 36 -> {L} layers) mesh {label} rank {r}: "
                      f"losses {[round(x['loss'], 5) for x in log]}, step "
                      f"ms {[round(x['ms'], 1) for x in log]} (median "
                      f"after the first {steady:.1f}, "
                      f"{tokens / steady * 1e3:.0f} tokens/s"
                      f"{'; two gloo ranks time-sharing one card, not a TP speed' if len(ranks) > 1 and dev == 'cuda' else ''}"
                      f"), after the last update {out['after']:.4f}; set-up "
                      f"{out['t_init']:.1f}s; peak {out['peak']:.2f} GiB "
                      f"({out['reserved']:.2f} reserved; this process held "
                      f"{held:.2f} GiB) ({SMI})")
        for r, out in enumerate(two):
            c = out["collectives"]
            per_step = {k: v / TP_STEPS for k, v in c.items()}
            require(c["reduce"] == c["copy"] == 2 * L * TP_STEPS
                    and c["other"] == TP_STEPS,
                    f"9k (a) rank {r}: all-reduces over model {c} in "
                    f"{TP_STEPS} steps, not 2 x {L} reduces and 2 x {L} "
                    f"copies a step and the grad norm's")
            print(f"[train:tp:collectives] rank {r}, a step: all-reduces "
                  f"over model {per_step['reduce'] + per_step['copy']:.0f} "
                  f"= 4 x {L} layers ({per_step['reduce']:.0f} "
                  f"reduce-from-model forward, {per_step['copy']:.0f} "
                  f"copy-to-model backward) + 0 for the gathered leaves "
                  f"(their {per_step['gather']:.0f} all-gathers' backward "
                  f"takes the rank's chunk) + {per_step['other']:.0f} (the "
                  f"grad norm, over every rank: here the model axis)")
        gap = abs(two[0]["log"][0]["loss"] - one["log"][0]["loss"]) / abs(
            one["log"][0]["loss"])
        require(gap <= 5e-3, f"9k (a): step 1's loss at {TP_MESH} "
                f"{two[0]['log'][0]['loss']} off the one-rank run's "
                f"{one['log'][0]['loss']} by {gap:.3g} relative")
        require([x["loss"] for x in two[0]["log"]]
                == [x["loss"] for x in two[1]["log"]],
                "9k (a): the two model ranks' losses differ")
        print(f"[train:tp] step 1's loss at {TP_MESH} "
              f"{two[0]['log'][0]['loss']:.6f} vs one rank "
              f"{one['log'][0]['loss']:.6f}: {gap:.3g} relative (bf16 "
              f"partial sums; limit 5e-3)")
        launches = {}
        for kern in ("flash_attention.train", "flash_attention_bwd"):
            want = (2 if kern == "flash_attention.train" else 1) \
                * L * TP_STEPS
            got = [out["launches"][kern] for out in two]
            require(all(g == (want if dev == "cuda" else 0) for g in got),
                    f"9k (a): {kern} launched {got} times on the ranks, not "
                    f"{want} each")
            launches[f"{kern}.tp"] = sum(got)
        # (b)
        t_b = time.perf_counter()
        case = dict(part="narrow", archs=TP_ARCHS, mesh=list(TP_MESH))
        on_dev = run(2, device=dev, args=[dict(
            case, device=dev, ckpt_dir={ARCH: str(tmp / "tp")})])[0]
        choices = {}
        for arch, out in on_dev.items():
            if out["choices"]:
                choices[arch] = str(tmp / f"{arch}.choices.pt")
                torch.save(out["choices"], choices[arch])
        on_cpu = run(2, device="cpu", args=[dict(case, device="cpu",
                                                 choices=choices)])[0]
        qwen_cpu = on_cpu[ARCH]["loss"]
        for arch in TP_ARCHS:
            a, b = on_dev[arch]["loss"], on_cpu[arch]["loss"]
            require(all(abs(x - y) <= 1e-4 * abs(y) for x, y in zip(a, b)),
                    f"9k (b) {arch}: {dev} losses {a} off the CPU's {b}")
            routed = (f"; the CPU ranks took the {dev} ranks' expert "
                      f"choices, their own the same for "
                      f"{on_cpu[arch]['routed_alike']:.1%}"
                      if arch in choices else "")
            print(f"[train:tp:agreement] f32 {arch} at {TP_MESH}: {dev} "
                  f"ranks' losses {[round(x, 6) for x in a]} within 1e-4 "
                  f"of the CPU ranks' {[round(x, 6) for x in b]}{routed}")
        # (c)
        t_c = time.perf_counter()
        step2 = tmp / "tp" / "step_00000002"
        shutil.copytree(step2, tmp / "reshard" / step2.name)
        res = run(2, device="cpu", args=[dict(
            part="reshard", device="cpu", mesh=[2, 1],
            ckpt_dir=str(tmp / "reshard"))])
        saved = _saved_arrays(step2)
        for r, got in enumerate(res):
            require(got["start"] == 2, f"9k (c): rank {r} resumed at "
                    f"{got['start']}")
            require(all(abs(x - y) <= 1e-4 * abs(y)
                        for x, y in zip(got["losses"], qwen_cpu[2:])),
                    f"9k (c): rank {r}'s losses {got['losses']} off (b)'s "
                    f"CPU run's {qwen_cpu[2:]}")
            for part, prefix in (("params", "params/"), ("mu", "opt/mu/"),
                                 ("nu", "opt/nu/")):
                for n, t in got[part].items():
                    require(np.array_equal(t.numpy(), saved[prefix + n]),
                            f"9k (c): rank {r}'s restored {prefix}{n} "
                            f"differs from the saved array")
        print(f"[train:tp:reshard] the {dev} ranks' {TP_MESH} step-2 "
              f"checkpoint resumed on 2 gloo CPU ranks at (2, 1) "
              f"({res[0]['sharded']} leaves' moments sharded): state bit "
              f"for bit the saved arrays; losses "
              f"{[round(x, 6) for x in res[0]['losses']]} within 1e-4 of "
              f"(b)'s CPU run's {[round(x, 6) for x in qwen_cpu[2:]]}")
        t_end = time.perf_counter()
        print(f"[train:tp] 9k took {t_end - t0:.1f}s: (a) one rank "
              f"{t_one - t0:.1f}s, two ranks {t_two - t_one:.1f}s (both with "
              f"set-up; the ranks' process starts included), (b) "
              f"{t_c - t_b:.1f}s, (c) {t_end - t_c:.1f}s")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- phase 10

SERVE_MESH = (1, 2)          # phase 10 (a): (data, model)
MOE_SERVE_MESH = (2, 2)      # phase 10 (b): the 2-D expert parallelism
SERVE_LENGTHS = (3000, 3350, 3700, 4000)   # (a): 3-4 frames of 1024 tokens
MOE_SERVE_LENGTHS = (1100, 1500, 2100, 2500)   # (b), (c): 2-3 frames
SERVE_STEPS = 16             # (a), (b): decode steps
NARROW_SERVE_STEPS = 4       # (c), (g)
SERVE_ARCHS = (ARCH, MLA_ARCH, MOE_ARCH)   # (c)
# (g): the hybrid, ssm, encdec and vlm families' narrow models.
FAMILY_SERVE_ARCHS = (HYBRID_ARCH, SSM_ARCH, ENCDEC_ARCH, VLM_ARCH)
# (a), (b): the mesh's bf16 logits against one rank's, of their scale.  A
# model rank's attention and FFN outputs are bf16 partial products summed
# across ranks where one rank rounds the whole product once, and the
# vocabulary-split logits come from [d] x [V / tp] products: each layer
# adds up to a bf16 ulp (2^-8) of its residual update in another place.
# On the H100 the sound runs read 9.8e-3 (a) and 1.15e-2 (b) and the
# negative controls 0.127 (a, "combine") and 0.0604 (b, "shared"): the
# limit sits about halfway between them on a log scale, over 2x from
# each.
MESH_LOGITS_TOL = 2.5e-2
# (e): a Mamba-2 stack with random weights amplifies rounding more than
# an attention stack (tests/torch_mamba_sensitivity.py, f32 on the CPU,
# these weights: a change of 2.3e-7 of the embedding moves the logits of
# zamba2 at 12 of 38 layers by 1.3e-5 of their scale in the reference and
# 1.7e-5 in the port, 56x and 71x; qwen2.5-3b's at 4 layers 5.9x and
# 2.9x), so bf16 alone moves zamba2's logits by more than
# MESH_LOGITS_TOL: on the H100 one rank's bf16 run lies 0.101 of the
# scale off its f32 twin.  (e) is therefore held in f32: the mesh's f32
# logits against one rank's f32 run within MAMBA_MESH_F32_TOL, and the
# "ssm_norm" fault beyond it.  On the H100 the sound run reads 1.49e-4
# and the fault 0.194: the limit sits halfway between them on a log
# scale, over 30x from each.  (e)'s bf16 mesh run, the main path, is a
# sanity check: no further from one rank's bf16 run than that run lies
# from f32.
MAMBA_MESH_F32_TOL = 5e-3
# (a), (b): greedy tokens of the mesh's logits that may differ from one
# rank's (bf16 near-ties of random weights' logits), of 68 a run.
MESH_TOKEN_MISSES = 2
# (a), (b), (e), (f): the negative control, a deliberate fault run for
# FAULT_STEPS decode steps after the sound run from the pools as prefill
# left them: its logits must sit beyond the run's limit and
# MESH_LOGITS_TOL, or the limit could not tell a broken mesh path from a
# sound one.  (e)'s runs in f32 (MAMBA_MESH_F32_TOL).
MESH_FAULTS = {"a": "combine", "b": "shared", "e32": "ssm_norm",
               "f": "cross"}
FAULT_STEPS = 2
NARROW_SERVE_TOL = 1e-4      # (c): f32 card ranks against f32 CPU ranks

_SEED_ONES = ("ln1", "ln2", "final_norm", "kv_norm", "q_norm", "k_norm",
              "ln", "mamba_ln", "tail_ln", "ln_cross", "enc_norm", "norm_w",
              "D")
_SEED_ZEROS = ("bq", "bk", "bv", "conv_b", "dt_bias")
_SEED_EMBEDS = ("embed", "unembed")


def _draw(name, shape, gen, device):
    """One layer slice of the leaf ``name`` in f32 (``seeded_weights``)."""
    import torch
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _SEED_ONES:
        return torch.ones(shape, device=device)
    if leaf in _SEED_ZEROS:
        return torch.zeros(shape, device=device)
    if leaf == "A_log":        # init_mamba_params: decay rates 1 .. 16
        return torch.log(torch.linspace(1.0, 16.0, shape[-1],
                                        device=device))
    w = torch.empty(shape, dtype=torch.float32, device=device)
    if leaf in _SEED_EMBEDS:
        return torch.nn.init.normal_(w, 0.0, 1.0, generator=gen).mul_(0.02)
    experts = ".moe." in name and leaf in ("w_gate", "w_up", "w_down")
    fan_in = shape[1] if experts else shape[0]
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return w.mul_(max(1.0, fan_in) ** -0.5)


def _layer_axes(cfg, name):
    """The layer axes of the leaf ``name``: the hybrid's grouped Mamba-2
    leaves two ([G, period]), its shared block none, every other leaf of a
    stack (``decoder.*``, ``decoder_prefix.*``, ``encoder.*``) one, the
    rest none."""
    if not name.startswith(("decoder.", "decoder_prefix.", "encoder.")) \
            or name.startswith("decoder.shared."):
        return 0
    if cfg.family == "hybrid" and name.startswith(("decoder.mamba.",
                                                   "decoder.mamba_ln")):
        return 2
    return 1


def seeded_weights(cfg, device, mesh=None, rank=0, seed=0):
    """Phase 10's weights of ``cfg`` in ``cfg.dtype`` on ``device``: each
    leaf's layer slice drawn from a generator of its own (seed, leaf,
    layer): norms 1, biases 0, embeddings N(0, 1) x 0.02, the Mamba-2
    scalars as ``init_weights`` (A_log log 1 .. 16, D 1, dt_bias and conv_b
    0), the rest truncated normal over the square root of the slice's
    fan-in (an expert's d or fe, another weight's first dim, as
    ``init_weights``).  With ``mesh`` the rank's serving shard, cut from
    each drawn slice: the same numbers as the whole model's, and no
    process holds more than its shard and one slice."""
    import torch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.sharding import serving_placements
    from repro_torch.models.lm import LM
    meta = dict(LM(cfg, device="meta").named_parameters())
    places = (serving_placements(cfg, meta, Mesh(mesh, ("data", "model")),
                                 rank) if mesh else {})
    dtype = getattr(torch, cfg.dtype)
    out = {}
    for i, (name, p) in enumerate(meta.items()):
        place = places.get(name)
        n = _layer_axes(cfg, name)
        t = torch.empty(place.take(p).shape if place else p.shape,
                        dtype=dtype, device=device)
        flat = t.view(-1, *t.shape[n:]) if n else t[None]
        for l in range(math.prod(p.shape[:n])):
            gen = torch.Generator(device=device).manual_seed(
                seed * 1_000_003 + i * 4099 + (l + 1 if n else 0))
            w = _draw(name, tuple(p.shape[n:]), gen, device)
            if place:
                w = place.take(w.view((1,) * n + w.shape))[(0,) * n]
            flat[l].copy_(w)
        out[name] = t
    return out


def serve_tables(lengths, mesh, steps):
    """The PageCtx fields (CPU tensors) of a prefill of ``lengths``' rows
    and of ``steps`` decode steps over ``mesh`` ((data, model); (1, 1): one
    rank), and the pages a rank's pool needs: one ``ShardedKVCache`` per
    data cell, its rows' frames striped over ``model``."""
    import torch
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.serving.kv_cache import ShardedKVCache
    geo = PoolGeometry()
    D, M = mesh
    frames = -(-(max(lengths) + steps) // (geo.frame_pages
                                           * geo.page_tokens))
    mpps = -(-frames // M) * geo.frame_pages
    per = len(lengths) // D
    pages = mpps * per
    caches = [ShardedKVCache(geo, pages, M) for _ in range(D)]
    for i, n in enumerate(lengths):
        caches[i // per].allocate(i, n)

    def pack():
        parts = [caches[c].pack_ctx(list(range(c * per, (c + 1) * per)),
                                    mpps) for c in range(D)]
        return {k: torch.cat([getattr(p, k) for p in parts])
                for k in ("tables", "ntok", "wpage", "wslot")}
    out = {"pages": pages, "prefill": pack(), "decode": []}
    for _ in range(steps):
        for i in range(len(lengths)):
            caches[i // per].append(i)
        out["decode"].append(pack())
    return out


@contextlib.contextmanager
def mesh_fault(kind):
    """Phase 10's negative control: a deliberate fault in the mesh path
    while the block runs.  ``combine``: each page rank normalises its own
    stripe's partials (``combine_partials`` given no group), the decode
    attention then misses the other stripes' pages; ``shared``: every data
    rank adds the shared experts in the 2-D EP decode (the reference's
    fault, ROADMAP Queue 3); ``ssm_norm``: the Mamba-2 gated norm sums its
    squares over the rank's heads only (no sum over ``model``); ``cross``:
    the cross-attention's partial outputs are not summed over ``model``."""
    from repro_torch.models import encdec, mamba2, moe, paged
    if kind == "combine":
        mod, name = paged, "combine_partials"
        orig = paged.combine_partials

        def faulty(o, m, l, group=None):
            return orig(o, m, l, None)
    elif kind == "shared":
        mod, name = moe, "_adds_shared"
        orig = moe._adds_shared

        def faulty(cfg, p, par, over_data):
            return orig(cfg, p, par, False)
    else:
        mod, name = {"ssm_norm": (mamba2, "_sum_sq_over_model"),
                     "cross": (encdec, "_reduce_cross")}[kind]
        orig = getattr(mod, name)

        def faulty(par, t):
            return t
    setattr(mod, name, faulty)
    try:
        yield
    finally:
        setattr(mod, name, orig)


def _page_ctx(fields, dev):
    from repro_torch.models.page_ops import PageCtx
    return PageCtx(**{k: v.to(dev) for k, v in fields.items()})


def serve_prompts(lengths, vocab, seed=10):
    """[B, T] prompt tokens (right-padded with 0 to a page multiple)."""
    import torch
    T = -(-max(lengths) // 64) * 64
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lengths), T), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(0, vocab, n)
    return torch.from_numpy(toks)


def serve_batch(cfg, lengths, dev, seed=10):
    """The prefill batch of ``lengths``' prompts (global rows): the tokens
    and, for vlm, ``frontend_tokens`` patch embeddings, for encdec
    ``source_len`` source frames, N(0, 1) from a numpy seed in
    ``cfg.dtype``."""
    import torch
    batch = {"tokens": serve_prompts(lengths, cfg.vocab_size, seed).to(dev)}
    rng = np.random.default_rng(seed + 1)
    dtype = getattr(torch, cfg.dtype)
    for key, n in (("patch_embeds", cfg.frontend_tokens
                    if cfg.family == "vlm" else 0),
                   ("src_embeds", cfg.encdec.source_len
                    if cfg.family == "encdec" else 0)):
        if n:
            batch[key] = torch.from_numpy(rng.standard_normal(
                (len(lengths), n, cfg.d_model), np.float32)).to(dev, dtype)
    return batch


def _mesh2(mesh):
    from repro_torch.launch.mesh import Mesh
    return Mesh(mesh, ("data", "model"))


def _serve_ctx(mesh):
    """(this rank, its serving ParallelCtx) on ``mesh`` ((1, 1): rank 0,
    None)."""
    import torch.distributed as dist
    from repro_torch.models.common import serving_ctx
    if math.prod(mesh) == 1:
        return 0, None
    rank = dist.get_rank()
    return rank, serving_ctx(_mesh2(mesh), rank)


def serve_cfg(case):
    """The model of a phase-10 case: (a), (b), (e), (f) at the published
    widths and depth or, rehearsed on the CPU, the smoke config, in
    ``case["dtype"]`` where given (the f32 twin of (e) and (f)); (c), (g)
    ``narrow_tp_config``'s f32 model."""
    from repro_torch.configs import get_config, get_smoke_config
    if case["part"] == "narrow":
        return narrow_tp_config(case["arch"])
    cfg = (get_config if case["width"] == "full" else get_smoke_config)(
        case["arch"])
    return dataclasses.replace(cfg, dtype=case.get("dtype", cfg.dtype))


def greedy_tokens(logits, par):
    """The batch's greedy tokens (a list, every row) from this rank's
    logits: over a batch split across data ranks, every data rank's rows
    gathered, since ``decode_step`` takes the global batch's tokens."""
    from repro_torch.models.common import gather_dim
    nxt = logits.argmax(-1)
    if par is not None and par.batch_sharded and par.dp_size > 1:
        nxt = gather_dim(nxt.contiguous(), 0, par.dp_group, par.dp_size)
    return nxt.tolist()


def serve_run(case):
    """One phase-10 serving run on this process's rank of ``case["mesh"]``
    (a (1, 1) mesh: this process, no group): the model's weights (this
    rank's serving shard), its pools, a prefill of ``case["lengths"]``'
    prompts and ``case["steps"]`` decode steps fed ``case["feed"]``'s
    tokens (None: each step's greedy tokens), the decode state carried
    from call to call; launch counters reset just before the prefill and
    read after the last step.  Returns the logits of every call (this
    rank's rows, f32 on the CPU), the tokens fed, the prefill and step ms
    (host clock, synchronised), memory and launches."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.sharding import serving_lm, serving_shard
    dev = case["device"]
    cfg = serve_cfg(case)
    mesh = tuple(case["mesh"])
    rank, par = _serve_ctx(mesh)
    reset_peak(dev)
    t0 = time.perf_counter()
    if case["part"] == "narrow":
        w = narrow_dist_weights(cfg)
        shards = serving_shard(cfg, w, _mesh2(mesh), rank) if par else w
    else:
        shards = seeded_weights(cfg, dev, mesh if par else None, rank)
    lm = serving_lm(cfg, shards, dev)
    del shards
    lengths = case["lengths"]
    # vlm's pools hold the patch positions in front of each prompt.
    n_pre = cfg.frontend_tokens if cfg.family == "vlm" else 0
    tabs = serve_tables([n + n_pre for n in lengths], mesh, case["steps"])
    pool_dtype = torch.float32 if case["part"] == "narrow" else None
    pools = [torch.zeros((s[0], tabs["pages"], *s[2:]),
                         dtype=pool_dtype or dt, device=dev)
             for s, dt in lm.pool_shapes(tabs["pages"], 64) or ()] or None
    t_init = time.perf_counter() - t0
    batch = serve_batch(cfg, lengths, dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    ops.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    logits, pools, state = lm.prefill(batch, pools,
                                      _page_ctx(tabs["prefill"], dev),
                                      lens - 1, par=par)
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    del batch
    fault = case.get("fault")
    snap = ([p.clone() for p in pools or ()],
            {k: v.clone() for k, v in state.items()}) if fault else None
    out, fed, step_ms = [logits.float().cpu()], [], []
    for s in range(case["steps"]):
        nxt = (case["feed"][s] if case.get("feed")
               else greedy_tokens(logits, par))
        fed.append(nxt)
        t0 = time.perf_counter()
        logits, pools, state = lm.decode_step(
            torch.tensor(nxt, dtype=torch.int32, device=dev),
            lens + n_pre + s, pools, _page_ctx(tabs["decode"][s], dev),
            state, par=par)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        out.append(logits.float().cpu())
    launches = read_counts()
    res = {"logits": out, "fed": fed, "prefill_ms": prefill_ms,
           "fault": fault,
           "step_ms": step_ms, "t_init": t_init, "peak": peak_gib(dev),
           "launches": launches, "rank": rank,
           "weights_gib": sum(p.numel() * p.element_size()
                              for p in lm.parameters()) / 2**30}
    if case["part"] == "narrow" and pools:
        res["k_pool"] = pools[0].cpu()
    if fault:
        res["fault_logits"] = []
        pools, state = snap
        del snap
        with mesh_fault(fault):
            for s in range(FAULT_STEPS):
                logits, pools, state = lm.decode_step(
                    torch.tensor(fed[s], dtype=torch.int32, device=dev),
                    lens + n_pre + s, pools or None,
                    _page_ctx(tabs["decode"][s], dev), state, par=par)
                res["fault_logits"].append(logits.float().cpu())
    return res


def serve_mesh_rank(cases):
    """Phase 10's work on one rank of a gloo group that ``run_ranks``
    started: {name: ``serve_run(case)``} of each case in turn (the card's
    ranks all on cuda:0)."""
    import torch
    if any(c["device"] == "cpu" for c in cases.values()):
        torch.set_num_threads(1)
    out = {}
    for name, case in cases.items():
        out[name] = serve_run(case)
        gc.collect()
        if case["device"] == "cuda":
            torch.cuda.empty_cache()
    return out


def _global_rows(ranks, mesh, key, call, field="logits"):
    """The global batch's logits (``field``) of ``call`` from the ranks of
    ``mesh``: each data rank's rows from its model rank 0 (its model ranks
    must agree to the bit)."""
    import torch
    D, M = mesh
    for r, out in enumerate(ranks):
        a, b = out[key][field][call], ranks[(r // M) * M][key][field][call]
        require(torch.equal(a, b), f"phase 10 {key}: model ranks of data "
                f"rank {r // M} disagree on call {call}'s {field}")
    return torch.cat([ranks[d * M][key][field][call] for d in range(D)])


def _scaled_gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


def full_launches(cfg, steps):
    """The launches each rank of (a), (b), (e), (f) makes in a prefill and
    ``steps`` decode steps: a flash call per attention layer at prefill
    and a paged call per layer and step; the hybrid's attention is its
    shared block's G invocations, after an SSD scan per Mamba-2 layer at
    prefill; encdec's flash also runs its encoder's layers, and its
    cross-attention per decoder layer at prefill and at every step."""
    from repro_torch.models.lm import LM
    L = LM(cfg, device="meta").kv_layers()
    out = {"flash_attention": L, "paged_attention.page": L * steps}
    if cfg.family == "hybrid":
        out["ssd_scan"] = cfg.n_layers
    if cfg.family == "encdec":
        enc = cfg.encdec.enc_layers
        out.update({"flash_attention": enc + L * (2 + steps),
                    "flash_attention.encoder": enc,
                    "flash_attention.cross_prefill": L,
                    "flash_attention.cross_decode": L * steps})
    return out


def _agreement(label, run, want):
    """(each call's gap of the scale, greedy tokens that agree, tokens) of
    ``run``'s logits (a list per call) against ``want``'s."""
    gaps, agree, n = [], 0, 0
    for call, (got, ref) in enumerate(zip(run, want["logits"])):
        require(bool(np.isfinite(got.numpy()).all()),
                f"10 {label}: non-finite logits at call {call}")
        gaps.append(_scaled_gap(got, ref))
        agree += int((got.argmax(-1) == ref.argmax(-1)).sum())
        n += ref.shape[0]
    return gaps, agree, n


def check_full_mesh(label, one, ranks, mesh, cfg, dev, key="full",
                    limit=MESH_LOGITS_TOL, misses=MESH_TOKEN_MISSES,
                    why="bf16 partial sums"):
    """(a), (b), (e), (f): the mesh's logits against one rank's, launches
    per rank (:func:`full_launches`), times and memory.  The logits must
    lie within ``limit`` of their scale and all but ``misses`` greedy
    tokens agree (``why`` says what sets the limit); the run's negative
    control, where it has one, beyond both ``limit`` and MESH_LOGITS_TOL.
    Returns each launch count summed over the ranks."""
    steps = len(one["fed"])
    mesh_run = [_global_rows(ranks, mesh, key, call)
                for call in range(1 + steps)]
    gaps, agree, n = _agreement(label, mesh_run, one)
    worst = max(gaps)
    require(worst <= limit, f"10 {label}: logits {worst:.3g} of their "
            f"scale off one rank's (limit {limit:.3g}: {why}); per call "
            f"{[round(g, 5) for g in gaps]}")
    require(agree >= n - misses, f"10 {label}: greedy tokens agree with "
            f"one rank's on {agree} of {n} (at most {misses} may differ: "
            f"{why})")
    fault = ranks[0][key]["fault"]
    control = "no negative control"
    if fault:
        faulty = max(_scaled_gap(_global_rows(ranks, mesh, key, s,
                                              "fault_logits"),
                                 one["logits"][1 + s])
                     for s in range(FAULT_STEPS))
        bar = max(limit, MESH_LOGITS_TOL)
        require(faulty > bar, f"10 {label}: the {fault!r} fault's logits "
                f"are {faulty:.3g} of their scale off one rank's, inside "
                f"{bar:.3g}: the check cannot see it")
        control = (f"negative control, the {fault!r} fault over "
                   f"{FAULT_STEPS} decode steps: {faulty:.3g} of the scale "
                   f"off ({faulty / limit:.3g}x the limit, "
                   f"{faulty / MESH_LOGITS_TOL:.3g}x MESH_LOGITS_TOL)")
    on_card = dev == "cuda"
    want = {k: n if on_card else 0
            for k, n in full_launches(cfg, steps).items()}
    for r, out in enumerate(ranks):
        c = out[key]["launches"]
        got = {k: c.get(k, 0) for k in want}
        require(got == want, f"10 {label} rank {r}: launched {got}, not "
                f"{want}")
    share = (", two gloo ranks time-sharing one card, not a TP speed"
             if on_card else "")
    print(f"[serve:mesh] {label}: one rank prefill "
          f"{one['prefill_ms']:.1f} ms, step ms median "
          f"{float(np.median(one['step_ms'])):.2f}, weights "
          f"{one['weights_gib']:.2f} GiB, peak {one['peak']:.2f} GiB "
          f"({SMI})")
    for r, out in enumerate(ranks):
        f = out[key]
        print(f"[serve:mesh] {label} mesh {mesh} rank {r}: prefill "
              f"{f['prefill_ms']:.1f} ms, step ms median "
              f"{float(np.median(f['step_ms'])):.2f} (min "
              f"{min(f['step_ms']):.2f}){share}; weights "
              f"{f['weights_gib']:.2f} GiB, peak {f['peak']:.2f} GiB, "
              f"set-up {f['t_init']:.1f}s ({SMI})")
    print(f"[serve:mesh] {label}: logits at {mesh} within {worst:.3g} of "
          f"their scale of one rank's over the prefill and {steps} steps "
          f"(limit {limit:.3g}: {why}); greedy tokens agree on {agree} of "
          f"{n} (at most {misses} may differ); {control}")
    return {k: sum(out[key]["launches"].get(k, 0) for out in ranks)
            for k in want}


def check_narrow_mesh(mesh, card, cpu, dev):
    """(c), (g): each narrow f32 model's logits (and deepseek's latent
    pools) on the card's ranks within NARROW_SERVE_TOL of the CPU
    ranks'."""
    for arch in SERVE_ARCHS + FAMILY_SERVE_ARCHS:
        key = f"narrow:{arch}"
        calls = len(card[0][key]["logits"])
        worst = 0.0
        for call in range(calls):
            got = _global_rows(card, mesh, key, call)
            want = _global_rows(cpu, mesh, key, call)
            worst = max(worst, _scaled_gap(got, want))
        extra = ""
        if arch == MLA_ARCH:
            pools = [_scaled_gap(a[key]["k_pool"], b[key]["k_pool"])
                     for a, b in zip(card, cpu)]
            worst = max([worst] + pools)
            extra = " and latent pools (prefill only: the MLA paged kernel "\
                    "takes bf16)"
        part = "(c)" if arch in SERVE_ARCHS else "(g)"
        require(worst <= NARROW_SERVE_TOL, f"10 {part} {arch} at {mesh}: "
                f"{dev} ranks {worst:.3g} of the scale off the CPU ranks")
        print(f"[serve:mesh:agreement] f32 {arch} at {mesh}: {dev} ranks' "
              f"logits{extra} over {calls} calls within {worst:.3g} of the "
              f"CPU ranks' (limit {NARROW_SERVE_TOL})")


def phase_serve_mesh(dev="cuda"):
    """Phase 10: serving over a mesh, in gloo ranks that ``run_ranks``
    starts, sharing cuda:0 on the card (NCCL cannot put two ranks on one
    GPU; every time printed is ranks time-sharing the card).  ``dev="cpu"``
    rehearses it on gloo CPU ranks with the smoke configs in (a), (b), (e)
    and (f).

    (a) qwen2.5-3b at its published width and depth, bf16, weights from
        ``seeded_weights``, at SERVE_MESH: B = 4 prompts of SERVE_LENGTHS
        tokens (3-4 frames: both page ranks hold pages of every row),
        prefill then SERVE_STEPS decode steps fed the one-rank run's greedy
        tokens; against the one-rank run in this process: logits within
        MESH_LOGITS_TOL of their scale, greedy tokens but MESH_TOKEN_MISSES
        the same, launches, prefill and step ms, peak GiB per rank; then the
        negative control, FAULT_STEPS decode steps under ``mesh_fault``'s
        "combine" fault, whose logits must lie beyond MESH_LOGITS_TOL;
    (b) deepseek-v2-lite at its published widths at MOE_SERVE_MESH (the
        2-D EP: 32 experts a data rank at a 704-wide hidden shard; MLA's
        striped latent pools), at its published depth (27 layers: ~8 GiB
        of weights a rank), B = 4 prompts of MOE_SERVE_LENGTHS tokens, as
        (a), the negative control under the "shared" fault;
    (c) the narrow f32 models of SERVE_ARCHS (``narrow_tp_config``) at
        SERVE_MESH and MOE_SERVE_MESH on the card's ranks and on gloo CPU
        ranks (run meanwhile, in a thread): logits within NARROW_SERVE_TOL
        (deepseek's prefill with its latent pools: the MLA paged kernel
        takes bf16 alone);
    (d) one dry-run line each (``launch/dryrun.py``) for qwen2.5-3b
        train_4k and decode_32k on the production 16 x 16 mesh;
    (e) zamba2-1.2b at its published width and depth (38 Mamba-2 layers,
        the shared block at 6 invocations), bf16, at SERVE_MESH, B = 4
        prompts of MOE_SERVE_LENGTHS tokens, as (a): the Mamba-2 layers on
        a rank's 32 of 64 heads, the shared block on its 16 of 32 heads
        over its stripe of the invocation-stacked pools.  Its rounding is
        amplified (MAMBA_MESH_F32_TOL's note), so the same model runs in
        f32 too, on one rank and on the mesh: the f32 mesh within
        MAMBA_MESH_F32_TOL of the f32 rank and its negative control, the
        "ssm_norm" fault, beyond it; the bf16 mesh no further from the
        bf16 rank than that lies from f32;
    (f) seamless-m4t-large-v2 at its published widths and depth (24 + 24
        layers), bf16, at SERVE_MESH, the same prompts over 4096 source
        frames each, as (a): the encoder and the cross-attention at a
        rank's 8 of 16 heads; the negative control under the "cross"
        fault;
    (g) the narrow f32 models of FAMILY_SERVE_ARCHS (mamba2, zamba2,
        seamless, llava), as (c).

    (a), (e) and (f)'s mesh runs share one start of SERVE_MESH's ranks,
    with (c) and (g)'s card cases.

    Returns {kernel entry: launches over every rank} of the bf16 runs:
    flash at (a)'s prefill (``flash_attention.mesh``) and at (b)'s
    (``flash_attention.mla.mesh``), paged at (a)'s decode
    (``paged_attention.mesh``) and at (b)'s (``paged_attention.mla.mesh``);
    (e)'s SSD scan at prefill (``ssd_scan.mesh``), its shared block's
    flash at prefill (``flash_attention.hybrid.mesh``) and paged at decode
    (``paged_attention.hybrid.mesh``); (f)'s flash at its encoder
    (``flash_attention.encoder.mesh``), decoder self-attention
    (``flash_attention.decoder.mesh``), cross-attention at prefill
    (``flash_attention.cross_prefill.mesh``) and at decode
    (``flash_attention.cross_decode.mesh``), and its decoder's paged
    attention (``paged_attention.encdec.mesh``)."""
    import threading
    from repro_torch.launch import dryrun
    from repro_torch.launch.spawn import run_ranks
    t_start = time.perf_counter()
    width = "full" if dev == "cuda" else "smoke"
    a = dict(part="full", arch=ARCH, width=width, device=dev,
             lengths=SERVE_LENGTHS if dev == "cuda" else MOE_SERVE_LENGTHS,
             steps=SERVE_STEPS if dev == "cuda" else 2)
    b = dict(a, arch=MLA_ARCH, lengths=MOE_SERVE_LENGTHS)
    e = dict(b, arch=HYBRID_ARCH)
    f = dict(b, arch=ENCDEC_ARCH)
    steps_c = NARROW_SERVE_STEPS

    def narrow(mesh, device):
        return {f"narrow:{arch}": dict(
            part="narrow", arch=arch, mesh=list(mesh), device=device,
            lengths=MOE_SERVE_LENGTHS, steps=0 if arch == MLA_ARCH
            else steps_c) for arch in SERVE_ARCHS + FAMILY_SERVE_ARCHS}
    run = functools.partial(
        run_ranks, "chip_smoke:serve_mesh_rank", paths=[str(ROOT)],
        timeout=600, backend="gloo", env=dict(
            os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))
    cpu_runs, cpu_err = {}, []

    def cpu_ranks():
        try:
            for mesh in (SERVE_MESH, MOE_SERVE_MESH):
                cpu_runs[mesh] = run(math.prod(mesh), device="cpu",
                                     args=[narrow(mesh, "cpu")])
        except Exception as exc:     # re-raised in the main thread
            cpu_err.append(exc)
    # On the card (c)'s CPU ranks run alongside; a rehearsal on the CPU
    # runs them first, one set of ranks at a time.
    thread = threading.Thread(target=cpu_ranks)
    (thread.start if dev == "cuda" else cpu_ranks)()
    t0 = time.perf_counter()
    try:
        one = {k: serve_run(dict(c, mesh=[1, 1]))
               for k, c in (("a", a), ("e", e), ("f", f))}
        e32 = dict(e, dtype="float32", feed=one["e"]["fed"])
        one["e32"] = serve_run(dict(e32, mesh=[1, 1]))
        t_one = time.perf_counter()
        reset_peak(dev)
        ranks_a = run(math.prod(SERVE_MESH), device=dev, args=[dict(
            **{f"full_{k}": dict(c, mesh=list(SERVE_MESH),
                                 feed=one[k]["fed"],
                                 fault=MESH_FAULTS.get(k))
               for k, c in (("a", a), ("e", e), ("e32", e32), ("f", f))},
            **narrow(SERVE_MESH, dev))])
        t_a = time.perf_counter()
        one_b = serve_run(dict(b, mesh=[1, 1]))
        reset_peak(dev)
        ranks_b = run(math.prod(MOE_SERVE_MESH), device=dev, args=[dict(
            full_b=dict(b, mesh=list(MOE_SERVE_MESH), feed=one_b["fed"],
                        fault=MESH_FAULTS["b"]),
            **narrow(MOE_SERVE_MESH, dev))])
        t_b = time.perf_counter()
    finally:
        if thread.is_alive():
            thread.join()
    if cpu_err:
        raise cpu_err[0]
    one["b"] = one_b
    # (e) in bf16, the sanity check: one rank's own distance from f32.
    f_gaps, f_agree, n = _agreement("(e)", one["e"]["logits"], one["e32"])
    floor = dict(limit=max(MESH_LOGITS_TOL, max(f_gaps)),
                 misses=max(MESH_TOKEN_MISSES, n - f_agree),
                 why=f"a sanity check: one rank's bf16 run lies "
                     f"{max(f_gaps):.3g} of the scale off its f32 twin, with "
                     f"{n - f_agree} of {n} greedy tokens different")
    counts = {}
    for k, c, mesh, ranks, what, lim in (
            ("a", a, SERVE_MESH, ranks_a, "width", {}),
            ("b", b, MOE_SERVE_MESH, ranks_b, "widths", {}),
            ("e", e, SERVE_MESH, ranks_a, "width, bf16", floor),
            ("e32", e32, SERVE_MESH, ranks_a, "width, f32", dict(
                limit=MAMBA_MESH_F32_TOL, why="f32 partial sums through "
                "an amplifying Mamba-2 stack")),
            ("f", f, SERVE_MESH, ranks_a, "widths", {})):
        cfg = serve_cfg(c)
        counts[k] = check_full_mesh(
            f"({k[0]}) {c['arch']} ({width} {what}, {cfg.n_layers} layers)",
            one[k], ranks, mesh, cfg, dev, key=f"full_{k}", **lim)
    for mesh, ranks in ((SERVE_MESH, ranks_a), (MOE_SERVE_MESH, ranks_b)):
        check_narrow_mesh(mesh, ranks, cpu_runs[mesh], dev)
    # (d)
    for shape in ("train_4k", "decode_32k"):
        rec = dryrun.run_cell(ARCH, shape, False)
        require(rec["per_device_bytes"]["total"] > 0
                and rec["bottleneck"] in ("compute_s", "memory_s",
                                          "collective_s"),
                f"10 (d): dry-run record {rec}")
        print(f"[serve:dryrun] {json.dumps(rec)}")
    print(f"[serve:mesh] phase 10 took {time.perf_counter() - t_start:.1f}s: "
          f"one-rank runs of (a), (e), (f) and (e)'s f32 twin "
          f"{t_one - t0:.1f}s, their ranks "
          f"{t_a - t_one:.1f}s, (b) {t_b - t_a:.1f}s (each with its ranks' "
          f"process starts; (c) and (g)'s card ranks inside them, their CPU "
          f"ranks {'alongside' if dev == 'cuda' else 'before'})")
    enc, cross_p, cross_d = (counts["f"][f"flash_attention.{site}"]
                             for site in ("encoder", "cross_prefill",
                                          "cross_decode"))
    return {"flash_attention.mesh": counts["a"]["flash_attention"],
            "paged_attention.mesh": counts["a"]["paged_attention.page"],
            "flash_attention.mla.mesh": counts["b"]["flash_attention"],
            "paged_attention.mla.mesh": counts["b"]["paged_attention.page"],
            "ssd_scan.mesh": counts["e"]["ssd_scan"],
            "flash_attention.hybrid.mesh": counts["e"]["flash_attention"],
            "paged_attention.hybrid.mesh":
                counts["e"]["paged_attention.page"],
            "flash_attention.encoder.mesh": enc,
            "flash_attention.decoder.mesh":
                counts["f"]["flash_attention"] - enc - cross_p - cross_d,
            "flash_attention.cross_prefill.mesh": cross_p,
            "flash_attention.cross_decode.mesh": cross_d,
            "paged_attention.encdec.mesh":
                counts["f"]["paged_attention.page"]}


def paged_mesh_entry(results, name, cfg, mesh, lengths, steps, what,
                     layers=None):
    """The paged kernel at a mesh rank's shard: rank 0's rows and table
    column of ``lengths``' last decode step over ``mesh``, every query
    head, against its plain version, timed cycling over the model's
    ``layers`` (default its layers) pools (CUDA-graph replay) beside its
    bound."""
    import torch
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    tabs = serve_tables(lengths, mesh, steps)
    last = tabs["decode"][-1]
    B = len(lengths) // mesh[0]
    tb = last["tables"][:B, 0].contiguous().to(dev)
    nt = last["ntok"][:B, 0].contiguous().to(dev)
    if cfg.mla is not None:
        m = cfg.mla
        H, n_kv = cfg.n_heads, 1
        dk, dv = m.kv_lora_rank + m.qk_rope_head_dim, m.kv_lora_rank
        scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    else:
        H, n_kv = cfg.n_heads, cfg.n_kv_heads
        dk = dv = cfg.resolved_head_dim
        scale = dk ** -0.5
    L, NP = layers or cfg.n_layers, tabs["pages"]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    q = randn(B, H, dk)
    kall, vall = randn(L, NP, 64, n_kv, dk), randn(L, NP, 64, n_kv, dv)
    o, m_, l = ops.paged_attention_kernel(q, kall[0], vall[0], tb, nt,
                                          granularity="page", scale=scale)
    o_r, m_r, l_r = ref.paged_attention_ref(q, kall[0], vall[0], tb, nt,
                                            scale=scale)
    torch.cuda.synchronize()
    on = o / torch.clamp(l[..., None], min=1e-30)
    on_r = o_r / torch.clamp(l_r[..., None], min=1e-30)
    # The MLA shape runs the tensor-core partials kernel (P rounded to
    # bf16): its output at the bf16 tolerance, as phase 3's rows 1m / 2m;
    # m and l, and the CUDA-core kernel's output, at the f32 one.
    torch.testing.assert_close(on, on_r, **(ATTN_TOL if cfg.mla is not None
                                            else ML_TOL))
    torch.testing.assert_close(m_, m_r, **ML_TOL)
    torch.testing.assert_close(l, l_r, **ML_TOL)
    tokens = int(nt.sum())
    nbytes = (tokens * n_kv * (dk + dv) * 2 + q.numel() * 2
              + 2 * tb.numel() * 4 + B * H * (dv + 2) * 4)
    b_ms, b_by = bound_ms(nbytes, 2 * H * (dk + dv) * tokens)
    layers = [(q, kall[i], vall[i], tb, nt) for i in range(L)]
    results[name] = dict(
        max_abs_err=float((on - on_r).abs().max()),
        ms=graph_ms(cycling(functools.partial(
            ops.paged_attention_kernel, granularity="page", scale=scale),
            layers)),
        plain_ms=eager_ms(cycling(functools.partial(
            ref.paged_attention_ref, scale=scale), layers)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"B={B} H={H} n_kv={n_kv} dk={dk} dv={dv} "
              f"blocks={tb.shape[1]} tokens={tokens}")
    r = results[name]
    print(f"[kernel] {name} ({what}): max_abs_err {r['max_abs_err']:.3g} | "
          f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
          f"{r['bound_ms']:.5f} ({b_by}) library_ms none | {r['shape']}")
    del kall, vall
    torch.cuda.empty_cache()


def ssd_mesh_entry(results, name, cfg, mesh, lengths, what):
    """The SSD scan at a mesh rank's heads: (e)'s prefill call of one
    Mamba-2 layer on model rank 0 (B = every row, T the padded prompt, nh
    / tp heads, its one B / C group), bf16 inputs drawn as phase 3's,
    against its plain version, timed beside its bound."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models.mamba2 import dims
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    _d_in, nh_all, _cd = dims(cfg)
    B, T = len(lengths) // mesh[0], serve_prompts(lengths, 2).shape[1]
    nh, hd = nh_all // mesh[1], cfg.ssm.head_dim
    N, G, Q = cfg.ssm.d_state, cfg.ssm.n_groups, min(cfg.ssm.chunk, T)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    x = randn(B, T, nh, hd).to(torch.bfloat16)
    dt = torch.rand((B, T, nh), generator=gen, device=dev) * 0.19 + 0.01
    A = -torch.linspace(1.0, 16.0, nh_all, device=dev)[:nh]
    Bm, Cm = (randn(B, T, G, N).to(torch.bfloat16) for _ in range(2))
    args = (x, dt, A, Bm, Cm)
    y, h = ops.ssd_scan(*args, chunk=Q)
    y_r, h_r = ref.ssd_scan_ref(*args, chunk=Q)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_r, **SSD_TOL)
    torch.testing.assert_close(h, h_r, **SSD_TOL)
    require(bool(torch.isfinite(y).all() and torch.isfinite(h).all()),
            f"{name}: non-finite")
    shape = (B, T, nh, hd, N, Q, False, G)
    b_ms, b_by = ssd_bound(*shape)
    results[name] = dict(
        max_abs_err=max(float((y - y_r).abs().max()),
                        float((h - h_r).abs().max())),
        ms=graph_ms(lambda: ops.ssd_scan(*args, chunk=Q)),
        plain_ms=eager_ms(lambda: ref.ssd_scan_ref(*args, chunk=Q),
                          iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape="B={} T={} nh={} hd={} N={} Q={} h0={} G={} bf16".format(
            *shape))
    r = results[name]
    print(f"[kernel] {name} ({what}): max_abs_err {r['max_abs_err']:.3g} | "
          f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
          f"{r['bound_ms']:.5f} ({b_by}) library_ms none (no single PyTorch "
          f"call computes an SSD scan) | {r['shape']}")
    del x, Bm, Cm, y, y_r
    torch.cuda.empty_cache()


def phase_mesh_kernels(results):
    """Phase 3 at phase 10's shard shapes: paged attention over rank 0's
    stripe of (a) (``paged_attention.mesh``: qwen2.5-3b's 16 heads over 2
    KV heads, every head on each page shard), of (b)
    (``paged_attention.mla.mesh``: a data rank's 2 rows over the latent
    pools), of (e) (``paged_attention.hybrid.mesh``: zamba2's shared
    block, 32 heads over 32 KV heads, over its 6 invocations' pools) and
    of (f) (``paged_attention.encdec.mesh``: seamless's decoder, 16 heads
    over 16 KV heads, over its 24 layers' pools); flash attention at (a)'s
    prefill on a model rank's 8 query heads over its 1 KV head
    (``flash_attention.mesh``), at (b)'s on a data rank's 2 rows and a
    model rank's 8 heads, dh 192 / dh_v 128 (``flash_attention.mla.mesh``),
    at (e)'s shared block on a model rank's 16 of 32 heads
    (``flash_attention.hybrid.mesh``), and at (f)'s four sites on a model
    rank's 8 of 16 heads: the encoder over 4096 frames, non-causal
    (``flash_attention.encoder.mesh``), the decoder's causal
    self-attention (``flash_attention.decoder.mesh``), the cross-attention
    at prefill (``flash_attention.cross_prefill.mesh``) and at decode,
    one query a row cycling the 24 layers' cross K/V
    (``flash_attention.cross_decode.mesh``); and the SSD scan at (e)'s
    prefill on a model rank's 32 of 64 heads (``ssd_scan.mesh``).  Every
    entry holds the kernel against its plain version."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.hybrid import n_invocations
    qwen = get_config(ARCH)
    ds = get_config(MLA_ARCH)
    zamba = get_config(HYBRID_ARCH)
    seamless = get_config(ENCDEC_ARCH)
    paged_mesh_entry(results, "paged_attention.mesh", qwen, SERVE_MESH,
                     SERVE_LENGTHS, SERVE_STEPS,
                     f"qwen2.5-3b rank 0 of {SERVE_MESH}")
    paged_mesh_entry(results, "paged_attention.mla.mesh", ds,
                     MOE_SERVE_MESH, MOE_SERVE_LENGTHS, SERVE_STEPS,
                     f"deepseek-v2-lite rank 0 of {MOE_SERVE_MESH}")
    gen = torch.Generator(device="cuda").manual_seed(12)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    T = serve_prompts(SERVE_LENGTHS, 2).shape[1]
    tp = SERVE_MESH[1]
    flash_entry(results, "flash_attention.mesh", len(SERVE_LENGTHS), T, T,
                qwen.n_heads // tp, qwen.n_kv_heads // tp,
                qwen.resolved_head_dim, True, randn,
                what=f"qwen2.5-3b's prefill on a model rank of {SERVE_MESH}")
    torch.cuda.empty_cache()
    m = ds.mla
    D, tp = MOE_SERVE_MESH
    T = serve_prompts(MOE_SERVE_LENGTHS, 2).shape[1]
    H = ds.n_heads // tp
    flash_entry(results, "flash_attention.mla.mesh",
                len(MOE_SERVE_LENGTHS) // D, T, T, H, H,
                m.qk_nope_head_dim + m.qk_rope_head_dim, True, randn,
                dh_v=m.v_head_dim,
                what=f"deepseek-v2-lite's MLA prefill on rank 0 of "
                     f"{MOE_SERVE_MESH}: a data rank's rows, a model rank's "
                     f"heads")
    torch.cuda.empty_cache()
    tp = SERVE_MESH[1]
    ssd_mesh_entry(results, "ssd_scan.mesh", zamba, SERVE_MESH,
                   MOE_SERVE_LENGTHS,
                   f"zamba2-1.2b's prefill on a model rank of {SERVE_MESH}")
    paged_mesh_entry(results, "paged_attention.hybrid.mesh", zamba,
                     SERVE_MESH, MOE_SERVE_LENGTHS, SERVE_STEPS,
                     f"zamba2-1.2b's shared block, rank 0 of {SERVE_MESH}",
                     layers=n_invocations(zamba))
    B, T = len(MOE_SERVE_LENGTHS), serve_prompts(MOE_SERVE_LENGTHS, 2).shape[1]
    flash_entry(results, "flash_attention.hybrid.mesh", B, T, T,
                zamba.n_heads // tp, zamba.n_kv_heads // tp,
                zamba.resolved_head_dim, True, randn,
                what=f"zamba2-1.2b's shared block at prefill on a model rank "
                     f"of {SERVE_MESH}")
    torch.cuda.empty_cache()
    dec = seamless.encdec.dec_layers
    paged_mesh_entry(results, "paged_attention.encdec.mesh", seamless,
                     SERVE_MESH, MOE_SERVE_LENGTHS, SERVE_STEPS,
                     f"seamless-m4t's decoder, rank 0 of {SERVE_MESH}",
                     layers=dec)
    S = seamless.encdec.source_len
    H, n_kv = seamless.n_heads // tp, seamless.n_kv_heads // tp
    dh = seamless.resolved_head_dim
    on_rank = f"on a model rank of {SERVE_MESH}"
    for name, Tq, Tk, causal, n_sets, what in (
            ("encoder", S, S, False, 1, "encoder"),
            ("decoder", T, T, True, 1, "decoder self-attention at prefill"),
            ("cross_prefill", T, S, False, 1, "cross-attention at prefill"),
            ("cross_decode", 1, S, False, dec,
             "cross-attention at decode")):
        flash_entry(results, f"flash_attention.{name}.mesh", B, Tq, Tk, H,
                    n_kv, dh, causal, randn, n_sets=n_sets,
                    what=f"seamless-m4t's {what} {on_rank}")
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 11

# The serving example's command lines on the card (README's, and the plain
# ``--requests 12``; the radix meter on the paging line), run one after
# the other in one process, and the smoke-size line of the CPU rehearsal.
EXAMPLE_SERVE = (
    ("--requests", "12"),
    ("--requests", "12", "--oversubscribe", "2", "--translation", "radix"),
    ("--requests", "12", "--shared-prefix", "40"),
    ("--requests", "12", "--shared-prefix", "40", "--engines", "2"),
    ("--requests", "12", "--shared-prefix", "40", "--engines", "2",
     "--capacity-frames", "4"),
)
EXAMPLE_SERVE_CPU = (("--requests", "4", "--oversubscribe", "2",
                      "--shared-prefix", "40", "--engines", "2",
                      "--translation", "radix"),)
# The training example's runs: its own demo-100m default (batch 8 x 256)
# on the card, the --tiny model at 2 x 16 in the rehearsal.  (i) 80 steps in
# directory A (a checkpoint at step 50); (ii) 80 steps --resume in B, which
# holds a copy of A's step-50 checkpoint.  The example sets the schedule's
# total_steps to --steps, as the reference's does, so a run resumed from
# the checkpoint of a run given other --steps (say a 60-step run's) follows
# no uninterrupted run's learning rates: no such run is made.
EXAMPLE_TRAIN = {"cuda": (), "cpu": ("--tiny", "--batch", "2", "--seq", "16")}
EXAMPLE_TRAIN_RUNS = (("a", 80, False), ("b", 80, True))
# Runs an example as ``python examples/<script> ARGS`` does (runpy, as
# __main__), once for each argument list of the JSON list argv[3], in one
# process (torch's import and the card's set-up paid once), each run's
# stdout after a line starting RUN_MARK.  Writes into the JSON file argv[1]
# a record per run: its wall seconds, its kernel launches (serving's
# ``ops.launch_counts()`` and training's ``ops.train_launch_counts()``,
# reset before the run) and, for the training example, Trainer.run's
# seconds and its log (every logged loss at full precision).
RUN_MARK = "### example run:"
_RECORDER = r"""
import json, runpy, sys, time
from repro_torch.kernels import ops
from repro_torch.train.trainer import Trainer
out, script, runs = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
run, recs = Trainer.run, []


def timed(self, n_steps, log_every=10):
    t0 = time.perf_counter()
    hist = run(self, n_steps, log_every)
    recs[-1].update(seconds=time.perf_counter() - t0, steps=n_steps,
                    start=self.start_step, log=self.log,
                    tokens=self.data.batch * self.data.seq_len)
    return hist


Trainer.run = timed
for args in runs:
    print(@MARK@, *args, flush=True)
    recs.append({})
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sys.argv = [script, *args]
    runpy.run_path(script, run_name="__main__")
    recs[-1].update(wall=time.perf_counter() - t0,
                    launches=ops.launch_counts(),
                    train_launches=ops.train_launch_counts())
with open(out, "w") as f:
    json.dump(recs, f)
""".replace("@MARK@", repr(RUN_MARK))
# The serving example's kernels at its shapes (the smoke qwen2.5-3b: 4
# query heads over 2 KV heads of 16, bf16; PoolGeometry(8, 4); max_seq 128;
# max_batch 4): entries ``<kernel>.smoke``, their launches those of phase
# 11's serving runs.  The prefill takes one request's prompt, the shared
# 40-token prefix and up to 104 tokens, page-padded.
EXAMPLE_HEADS = (4, 2, 16)               # H, n_kv, dh
EXAMPLE_PREFILL_T = 144
EXAMPLE_PAGES, EXAMPLE_PTOK, EXAMPLE_LAYERS = 64, 8, 2


def run_example(args, dev, label):
    """``python examples/<args...>`` from the checkout's root with
    ``PYTHONPATH=src``: its stdout, after its exit code 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if dev == "cpu":    # the plain versions on smoke-size tensors
        env["OMP_NUM_THREADS"] = "1"
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    require(out.returncode == 0,
            f"11 {label}: exit {out.returncode}: {out.stdout[-1500:]}"
            f"{out.stderr[-3000:]}")
    return out.stdout, wall


def record_example(script, runs, dev, label, rec_path):
    """``script`` run once for each argument list of ``runs`` in one
    process (:data:`_RECORDER`): each run's stdout and record."""
    text, _ = run_example(["-c", _RECORDER, str(rec_path), script,
                           json.dumps([list(r) for r in runs])], dev, label)
    recs = json.loads(Path(rec_path).read_text())
    outs = [part.split("\n", 1)[1] if "\n" in part else ""
            for part in text.split(RUN_MARK)[1:]]
    require(len(outs) == len(recs) == len(runs),
            f"11 {label}: {len(outs)} outputs and {len(recs)} records of "
            f"{len(runs)} runs")
    for rec, out in zip(recs, outs):
        rec["text"] = out
    return recs


def phase_examples(dev="cuda"):
    """Phase 11: the port's examples as a user runs them
    (``sys.executable`` on ``examples/torch_*.py`` with ``PYTHONPATH=src``;
    a non-zero exit fails the run):

    * ``torch_quickstart.py`` and ``torch_long_context.py --ctx 4096``
      (host-side), each its own process: the invariants hold, mosaic
      coalesces with 0 copies, and page-granular faults move fewer bytes
      than frame-granular ones;
    * ``torch_serve_multitenant.py --device <dev>`` on each of
      :data:`EXAMPLE_SERVE`'s command lines (the rehearsal:
      :data:`EXAMPLE_SERVE_CPU`'s), one after another in one process:
      outputs identical across managers, each run's wall seconds and its
      managers' tok/s printed, the kernel launches of every run summed (on
      the card the flash and page kernels must have launched);
    * ``torch_train_lm.py --device <dev>`` at its own demo-100m (the
      rehearsal: ``--tiny`` at 2 x 16), :data:`EXAMPLE_TRAIN_RUNS`, each
      its own process: (i) 80 steps in a directory A; (ii) 80 ``--resume``
      from a copy of A's step-50 checkpoint, which must print ``resuming
      from step 50`` and log after step 50 the losses run (i) logs at the
      same steps, bit for bit; run (i)'s last logged loss below its first;
      step ms and tokens/s of run (i); the training kernels' launches of
      both runs summed (on the card the flash forward with lse and the
      flash backward must have launched, and no serving kernel).

    Returns the resume's start step, the number of losses compared, the
    serving runs' launches and the training runs'."""
    import tempfile
    t_phase = time.perf_counter()
    text, _ = run_example(["examples/torch_quickstart.py"], dev, "quickstart")
    require("  invariants: OK" in text.splitlines(),
            f"11 quickstart: no 'invariants: OK': {text}")
    coalesce = [l for l in text.splitlines()
                if l.startswith("  mosaic coalesce ops:")]
    require(len(coalesce) == 1 and " with 0 copies " in coalesce[0],
            f"11 quickstart: mosaic's coalescing made copies: {coalesce}")
    text, _ = run_example(["examples/torch_long_context.py", "--ctx", "4096"],
                          dev, "long_context")
    moved = {}
    for line in text.splitlines():
        for gran in ("page", "frame"):
            if line.startswith(f"[{gran:5}-granular faults]"):
                moved[gran] = float(line.split("bytes_in=")[1].split()[0])
    require(set(moved) == {"page", "frame"}
            and moved["page"] < moved["frame"],
            f"11 long_context: page-granular faults moved {moved.get('page')}"
            f" MB, not fewer than frame-granular's {moved.get('frame')}")
    print(f"[example] quickstart: invariants OK, {coalesce[0].strip()}; "
          f"long_context --ctx 4096: page-granular {moved['page']:.2f} MB "
          f"vs frame-granular {moved['frame']:.2f} MB")
    tmp = Path(tempfile.mkdtemp(prefix="example_"))
    try:
        cmds = EXAMPLE_SERVE if dev == "cuda" else EXAMPLE_SERVE_CPU
        t0 = time.perf_counter()
        serves = record_example(
            "examples/torch_serve_multitenant.py",
            [(*cmd, "--device", dev) for cmd in cmds], dev, "serve",
            tmp / "serve.json")
        serve_wall = time.perf_counter() - t0
        launches = {}
        for cmd, rec in zip(cmds, serves):
            for k, n in rec["launches"].items():
                launches[k] = launches.get(k, 0) + n
            require(not any(rec["train_launches"].values()),
                    f"11 serve {' '.join(cmd)}: training kernels launched: "
                    f"{rec['train_launches']}")
            lines = rec["text"].splitlines()
            require("application-transparency: outputs identical across "
                    "managers = True" in lines,
                    f"11 serve {' '.join(cmd)}: outputs differ across "
                    f"managers")
            rates = {}
            for line in lines:
                for kind in ("mosaic", "gpu-mmu"):
                    if line.startswith(f"[{kind:8}]"):
                        rates[kind] = line.split(" tok/s (")[0].split("|")[-1]
                        require(f" tok/s ({dev}) " in line,
                                f"11 serve: {kind}'s tok/s not on {dev}: "
                                f"{line}")
            require(len(rates) == 2, f"11 serve {' '.join(cmd)}: no "
                    f"per-manager lines: {rec['text'][-2000:]}")
            if "--translation" in cmd:
                require(any("translation[radix]" in l for l in lines),
                        f"11 serve {' '.join(cmd)}: no translation line")
            print(f"[example] serve {' '.join(cmd)} --device {dev}: exit 0, "
                  f"{rec['wall']:.1f}s wall (both managers); tok/s mosaic "
                  f"{rates['mosaic'].strip()}, gpu-mmu "
                  f"{rates['gpu-mmu'].strip()} ({dev}); tokens identical "
                  f"across managers ({SMI})")
        print(f"[example] serve: {len(cmds)} command lines in one process, "
              f"{serve_wall:.1f}s wall with its start; kernel launches over "
              f"the runs {launches}")
        # On the CPU the wrappers run their plain versions and count nothing.
        require(dev == "cpu" or (launches["flash_attention"] > 0
                                 and launches["paged_attention.page"] > 0),
                f"11 serve: a kernel of the example's path never launched: "
                f"{launches}")
        recs = []
        for d, steps, resume in EXAMPLE_TRAIN_RUNS:
            if resume:
                step50 = tmp / "a" / "step_00000050"
                shutil.copytree(step50, tmp / d / step50.name)
            args = ("--steps", str(steps), "--ckpt-dir", str(tmp / d),
                    "--device", dev, *EXAMPLE_TRAIN[dev],
                    *(("--resume",) if resume else ()))
            rec, = record_example("examples/torch_train_lm.py", [args], dev,
                                  "train " + " ".join(args),
                                  tmp / f"train{len(recs)}.json")
            require(not any(rec["launches"].values()),
                    f"11 train {' '.join(args)}: serving kernels launched: "
                    f"{rec['launches']}")
            rec["loss"] = {r["step"]: r["loss"] for r in rec["log"]}
            recs.append(rec)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    first, again = recs
    train_launches = {k: first["train_launches"][k] + n
                      for k, n in again["train_launches"].items()}
    require(dev == "cpu" or (train_launches["flash_attention.train"] > 0
                             and train_launches["flash_attention_bwd"] > 0),
            f"11 train: a training kernel never launched: {train_launches}")
    require(train_launches["ssd_scan_bwd"] == 0,
            f"11 train: the dense model launched the SSD backward")
    require("resuming from step 50" in again["text"].splitlines(),
            f"11 train: run (ii) did not resume from step 50: "
            f"{again['text'][-1500:]}")
    require(again["start"] == 50, f"11 train: start {again['start']}")
    shared = [k for k in again["loss"] if k in first["loss"]]
    require(len(shared) >= 3 and all(again["loss"][k] == first["loss"][k]
                                     for k in shared),
            f"11 train: the resumed run's losses {again['loss']} are not "
            f"run (i)'s {first['loss']} at the same steps bit for bit")
    losses = [r["loss"] for r in first["log"]]
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"11 train: run (i)'s losses did not fall: {losses}")
    steady = (first["seconds"] * 1e3 - first["log"][0]["ms"]) \
        / (first["steps"] - 1)
    model = first["text"].splitlines()[0]
    print(f"[example] train_lm {model[len('model: '):]} on {dev}, "
          f"{first['tokens']} tokens a step: run (i) {first['steps']} "
          f"steps in {first['seconds']:.1f}s ({first['wall']:.1f}s with the "
          f"example's set-up), step 1 {first['log'][0]['ms']:.1f} ms, "
          f"steps 2-{first['steps']} {steady:.2f} ms a step "
          f"({first['tokens'] / steady * 1e3:.0f} tokens/s); loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; run (ii), resumed at "
          f"step 50, at steps {shared} bit for bit run (i)'s; training "
          f"kernel launches over both runs {train_launches} ({SMI})")
    print(f"[example] phase 11 took {time.perf_counter() - t_phase:.1f}s "
          f"({SMI})")
    return {"resumed": again["start"], "same_losses": len(shared),
            "launches": launches, "train_launches": train_launches}


# demo-100m's attention in training (examples/torch_train_lm.py): a
# microbatch of 4 rows (batch 8 over 2 microbatches) x 256 positions, 8
# query heads over 4 KV heads of 64, causal, bf16 (entries ``.example``).
EXAMPLE_TRAIN_SHAPE = ("example", "demo-100m's training attention, one "
                       "microbatch", 4, 256, 256, 8, 4, 64, True)


def phase_example_kernels(results, launched):
    """Phase 3 at the examples' shapes, each kernel against its plain
    version, for every kernel phase 11's runs launched (``launched``:
    phase_examples' result): at the serving example's (:data:`EXAMPLE_HEADS`,
    bf16), flash attention on one page-padded prefill
    (``flash_attention.smoke``: the CUDA-core path at head dim 16),
    page-granular paged attention at B = 1, 4 over a pool of 8-token pages
    with holes and partial last pages, 16 blocks a row
    (``paged_attention.page.smoke``, timed at B = 4 cycling the example's
    2 layers' pools) and the page copies on the example's 2-layer pool of
    512-byte pages (``page_gather.smoke`` ...); at the training example's
    (:data:`EXAMPLE_TRAIN_SHAPE`), the flash forward with lse and the
    backward (``flash_attention.train.example``,
    ``flash_attention_bwd.example``).  Returns the entries' launches."""
    import torch
    from repro_torch.kernels import ops, ref
    H, n_kv, dh = EXAMPLE_HEADS
    gen = torch.Generator(device="cuda").manual_seed(29)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    T = EXAMPLE_PREFILL_T
    flash_entry(results, "flash_attention.smoke", 1, T, T, H, n_kv, dh,
                True, randn, what="the serving example's prefill: smoke "
                                  "qwen2.5-3b, one page-padded prompt")
    rng = np.random.default_rng(29)
    L, NP, ptok = EXAMPLE_LAYERS, EXAMPLE_PAGES, EXAMPLE_PTOK
    n_blocks = 128 // ptok
    kall, vall = randn(L, NP, ptok, n_kv, dh), randn(L, NP, ptok, n_kv, dh)
    scale = dh ** -0.5
    name = "paged_attention.page.smoke"
    errs = []
    for B in (1, MAX_BATCH):
        q = randn(B, H, dh)
        tb, nt = (torch.from_numpy(a).cuda() for a in _tables(
            rng, B, n_blocks, NP, ptok))
        o, m, l = ops.paged_attention_kernel(q, kall[0], vall[0], tb, nt,
                                             granularity="page", scale=scale)
        o_r, m_r, l_r = ref.paged_attention_ref(q, kall[0], vall[0], tb, nt,
                                                scale=scale)
        torch.cuda.synchronize()
        on = o / torch.clamp(l[..., None], min=1e-30)
        on_r = o_r / torch.clamp(l_r[..., None], min=1e-30)
        for a, b in ((on, on_r), (m, m_r), (l, l_r)):
            torch.testing.assert_close(a, b, **ML_TOL)
        require(bool(torch.isfinite(on).all()), f"{name}: non-finite")
        errs.append(float((on - on_r).abs().max()))
    layers = [(q, kall[i], vall[i], tb, nt) for i in range(L)]
    tokens = int(nt.sum())
    b_ms, b_by = bound_ms(2 * tokens * n_kv * dh * 2 + q.numel() * 2
                          + 2 * tb.numel() * 4 + MAX_BATCH * H * (dh + 2) * 4,
                          4 * H * dh * tokens)
    results[name] = dict(
        max_abs_err=max(errs),
        ms=graph_ms(cycling(functools.partial(
            ops.paged_attention_kernel, granularity="page", scale=scale),
            layers)),
        plain_ms=eager_ms(cycling(functools.partial(
            ref.paged_attention_ref, scale=scale), layers)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"B={MAX_BATCH} H={H} n_kv={n_kv} dh={dh} blocks={n_blocks} "
              f"of {ptok} tokens, tokens={tokens}")
    r = results[name]
    print(f"[kernel] {name} (the serving example's decode): max_abs_err "
          f"{r['max_abs_err']:.3g} | kernel_ms {r['ms']:.4f} plain_ms "
          f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.5f} ({b_by}) "
          f"library_ms none (no single PyTorch call computes paged "
          f"attention) | {r['shape']}")
    # The example's pools [L, NP, 8 tokens, 2 KV heads, 16]: 512-byte pages.
    pool = randn(L, NP, ptok, n_kv, dh)
    check_copies(pool, rng, randn, "the serving example's pool")
    copy_entries(results, pool, rng, randn, ".smoke")
    del kall, vall, pool
    flash_train_entry(results, *EXAMPLE_TRAIN_SHAPE)
    served = {f"{k}.smoke": n for k, n in launched["launches"].items() if n}
    counts = {**served,
              "flash_attention.train.example":
                  launched["train_launches"]["flash_attention.train"],
              "flash_attention_bwd.example":
                  launched["train_launches"]["flash_attention_bwd"]}
    require(all(k in results for k in counts), f"11: the examples launched "
            f"kernels no entry holds at their shapes: "
            f"{sorted(k for k in counts if k not in results)}")
    for k in [k for k in results if k.endswith(".smoke")
              and k not in counts]:
        del results[k]          # held exactly, but not on phase 11's path
    return counts


def entry_kernel(name):
    """The kernel of a kernels-line entry: ``paged_attention.page.g4d128``
    -> ``paged_attention.page``, ``flash_attention.encoder`` ->
    ``flash_attention``."""
    return max((k for k in REPLACES if name == k or name.startswith(k + ".")),
               key=len)


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    last = [t_start]

    def lap(label):
        """Prints the seconds since the previous lap: where the run's
        time goes, against its limit."""
        now = time.perf_counter()
        print(f"[phase] {label}: {now - last[0]:.1f}s", flush=True)
        last[0] = now
    phase_env()
    phase_build()
    lap("1-2 environment and build")
    results = {}
    phase_kernels(cfg, results)
    phase_mla_kernels(results)
    phase_ssd_kernel(results)
    phase_family_kernels(results)
    lap("3 kernels")
    counts, params = phase_main_path(cfg)
    lap("4 main path")
    torch.cuda.empty_cache()
    phase_prefix(cfg, params)
    lap("4b prefix cache")
    for arch, modes, n in ((HYBRID_ARCH, MODES, 8),
                           (SSM_ARCH, SSM_MODES, SSM_REQUESTS)):
        for k, n_launch in phase_stream(get_config(arch), modes, n).items():
            counts[k] = counts.get(k, 0) + n_launch
    lap("4c-4d hybrid and ssm")
    phase_small_agreement(cfg)
    phase_transparency(cfg, params)
    lap("5-7 agreement, transparency, paging")
    del params                  # phase 4's copy of qwen2.5-3b leaves the card
    torch.cuda.empty_cache()
    for phase in (phase_cluster, phase_translation):
        for k, n_launch in phase(cfg).items():
            counts[k] = counts.get(k, 0) + n_launch
    phase_cluster_agreement(cfg)
    lap("8 cluster")
    mla_counts = phase_mla_serving()
    dbrx = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    for k, n_launch in phase_stream(dbrx, ("sync",), MOE_REQUESTS).items():
        counts[k] = counts.get(k, 0) + n_launch
    for k, n_launch in mla_counts.items():
        counts[f"{k}.mla"] = n_launch
    lap("4e-4f moe")
    tagged, rest = family_entries(phase_vlm(), phase_encdec(),
                                  phase_dense_archs())
    counts.update(tagged)
    for k, n_launch in rest.items():
        counts[k] = counts.get(k, 0) + n_launch
    lap("4g-4i vlm, encdec, dense")
    phase_optim_kernels(results)
    phase_train_kernels(results)
    phase_family_train_kernels(results)
    phase_moe_train_kernels(results)
    phase_tp_kernels(results)
    lap("9a training kernels")
    counts.update(phase_train(cfg))
    phase_train_agreement()
    lap("9b-9c training")
    phase_train_families(counts)
    lap("9d-9i families' training")
    for k, n_launch in phase_train_dist().items():
        counts[k] += n_launch
    lap("9j data parallelism")
    counts.update(phase_train_tp())
    lap("9k tensor parallelism")
    counts.update(phase_serve_mesh())
    phase_mesh_kernels(results)
    lap("10 serving over a mesh")
    counts.update(phase_example_kernels(results, phase_examples()))
    lap("11 examples")
    line = [dict(name=name, route="cuda",
                 source=SOURCES[entry_kernel(name)],
                 replaces=REPLACES[entry_kernel(name)],
                 launches=counts[name],
                 max_abs_err=r["max_abs_err"], ms=r["ms"],
                 plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                 bound_by=r["bound_by"], library_ms=r["library_ms"],
                 **{k: r[k] for k in ("library_bwd_ms",) if k in r})
            for name, r in results.items()]
    require(all(e["launches"] > 0 or e["name"] in ZERO_LAUNCHES
                for e in line),
            f"an entry's kernel never launched on its path: "
            f"{[e['name'] for e in line if not e['launches']]}")
    require(all(counts[k] == 0 for k in ZERO_LAUNCHES), "an entry of a "
            "shape no phase trains counted launches")
    for name, why in ZERO_LAUNCHES.items():
        print(f"[kernels] {name}: 0 launches: {why}")
    print(f"[total] chip_smoke.py ran {time.perf_counter() - t_start:.1f}s "
          f"({SMI})")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
