#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, all started together) and then, failing on the
first phase that does not hold:

1. prints the card (``nvidia-smi`` name and power limit) and the build time;
2. holds decode-attention kernels #1-#3 (fused, row max, attend) against
   their plain PyTorch versions at the serving shape (B=4, Hq=24, Hkv=8,
   S=512, D=128, bf16, random masks with empty rows), thresholds None and
   3.0, block_k 512 and 128, within 2e-2, and the two-pass pair at
   threshold 0 (every row that admits an entry keeps its maximum, bf16
   and float32); #1 on NaN scores (a NaN key row, a NaN ring), thresholds
   None and 3.0: its NaN rows those of its plain version, which takes
   the Pallas kernel's NaN-propagating running max; #2 and #3 on the
   same NaN keys (bf16 and float32): #2's NaN row maxima and #3's NaN
   rows (no threshold) and zero rows (threshold 3.0) those of their
   plain versions; prints each cluster
   size; times each kernel with CUDA
   events over inputs that exceed the 50 MB L2 (as the 32 layers of a
   decode step do) and by the device time per launch from
   ``torch.profiler`` (the event loop measures the host's enqueue once a
   call takes less device time than the wrapper's Python), beside its
   plain version, its bound and, for #1, the
   ``scaled_dot_product_attention`` yardstick (timed only; the port never
   calls it); then a long ring (S=4096, 2 input sets of 67 MB of K/V):
   #1-#3 against their plain versions once, the threshold-0 check, and
   each kernel by events and device time beside its bound;
3. main path: serves phi4-mini-3.8b at full width (random bf16 weights
   from seed 0; 4 slots, max_len 512, 8 requests of 64-token prompts, 16
   new tokens) through ``ServeEngine`` with A^3 off at decode_block 1 and
   4, and checks that the fused kernel ran 32 x decode_steps times;
   (3b) the same serve at decode_block 4 through the engine's pipelined
   harvest, pipeline_depth 0 and 1 (tokens identical), then tempered at
   temperature 0.8, depth 1, decode_block 1 and 4 (tokens identical
   across block sizes), #1 32 x decode_steps times in each, with tok/s,
   host syncs, stalls and the per-phase tick times, greedy and sampled
   in turns, and one 4-step decode block greedy and sampled under the
   profiler (the draw's device time and kernels); one steady depth-1
   decode tick under ``torch.cuda.set_sync_debug_mode("error")``; and a
   lifecycle run at depth 1 (a cancel mid-decode, a 3-tick deadline,
   ``drain()``, a submit after it) with the conservation identity held
   after every tick;
4. the same serve with A^3 conservative: tokens/s and the share of greedy
   tokens that agree with the A^3-off run;
5. two-pass path: ``a3_decode_attention(exact_two_pass=True)`` (the public
   ops entry, A^3 conservative, no cached sort) on a ring the model
   wrote, which launches kernels #2 and #3, against the same call on CPU;
6. the TINY f32 engine on the card vs the same port on the CPU: greedy
   tokens identical; (6b) at temperature 0.8 and pipeline_depth 1,
   sampled tokens identical;
7. A^3 prefill attention at phi4-mini width (B=1, Hq=24, Hkv=8, S=2048,
   D=128, bf16, causal): (a) flash kernel #4 (causal, window 512, a
   512-row continuation; every bf16 call must take the tensor-core
   route) and the sparse row-max / attend kernels #5/#6
   (random per-query-head map of density 0.5, diagonal kept, thresholds
   None and 3.0, bf16 and float32; the bf16 pair must take the
   tensor-core routes of both, the float32 pair both CUDA-core routes)
   against their plain versions within 2e-2, and at threshold 0 every
   row that admits an entry must keep its maximum (a non-zero output
   row); #4-#6 on a NaN key (bf16 and float32): NaN rows and #6's zero
   rows under threshold 3.0 those of their plain versions; each kernel
   timed over inputs larger than L2 beside its plain
   version, its bound and (for #4) ``scaled_dot_product_attention``,
   #4, #5, #6 and SDPA also by device time per call, #6 printed beside
   #4 on the same q/k/v; (b) the public
   ``a3_attention`` in modes off / conservative / aggressive on layer 0's
   q/k/v of the full-width model (2048 random tokens) and on clustered
   keys: live-block fraction, selection and kernel ms, op ms, peak
   memory, error against off, and launch counts (off: one #4 on the
   tensor-core route; A^3: one #5 and one #6, both on their tensor-core
   routes); (c) the same op on the card vs the CPU at a small float32
   shape: block maps identical, outputs within 1e-4, the CUDA-core
   routes taken; (d) #4-#6 at gemma3-4b's attention width (Hq=8, Hkv=4,
   S=2048, D=Dv=256; bf16 and float32, causal and window 1024) against
   their plain versions, all on their CUDA-core routes, then their times
   in bf16 beside SDPA's at the same shape and their bounds, computed as
   (a) computes them;
8. xLSTM: (a) the chunkwise mLSTM kernel #7 against its plain version at
   xlstm-350m's heads (B=4, H=4, S=2048, D=256, bf16 streams, float32
   gates, chunk 256) from the zero state, from a random carried state
   (the final state compared too), at the served prefill shape (S=512)
   and at an odd S=300, within 2e-4, all four on the tensor-core route,
   then its time over inputs larger than L2 by events and by device time
   beside its plain version and its bound (no single PyTorch call
   computes it); (b) main path: serves xlstm-350m at full width (24
   layers, 21 mLSTM + 3 sLSTM, random bf16 weights from seed 0; 4 slots,
   8 requests of 512-token prompts, 16 new tokens, decode_block 1 and 4)
   and checks that kernel #7 ran once per mLSTM layer per prefill
   dispatch, on its tensor-core route only; (8b') the decode_block-4
   serve again at pipeline_depth 1: tokens identical, #7 once per mLSTM
   layer per prefill dispatch; then one prefill dispatch
   under the profiler: its device busy time and share, and #7's part;
   (c) the TINY_XL f32 engine on the card vs the CPU: greedy tokens
   identical, #7 on its CUDA-core route.
9. the later families, each at full width and depth with random bf16
   weights from seed 0, one model on the card at a time (freed before the
   next): gemma3-4b (A^3 off and conservative; its 1024-row local rings
   wrap), recurrentgemma-2b, deepseek-moe-16b and h2o-danube-1.8b, served
   through ``ServeEngine`` (4 slots, max_len 2048, 4 requests of
   1536-token prompts, 8 new tokens, decode_block 4); #1 must launch once
   per attention layer that takes it per decode step (34, 8, 28, 24; 29
   for gemma3-4b conservative, whose 5 global layers take the compact
   path); #1 against its plain version on every input set of each
   model's rings as the A^3-off serve left them, at its (G, D, S) (within
   2e-2 of the output's largest magnitude; masking every other valid key
   must move it further), timed beside its plain version, SDPA and its
   bytes bound; tok/s, one decode step by events and under the profiler
   (device busy, kernels, top kernels; for the MoE the routed experts'
   share from the step's ``aten::bmm`` kernels), peak memory; (b) the
   tiny float32 RG-LRU,
   local/global (A^3 conservative) and MoE configs on the card vs the
   CPU: greedy tokens identical.
10. the paged prefix cache (run after 3b, on phase 3's model): 8 requests
   sharing a 1024-token prefix (seed-made tokens), each with its own
   64-token suffix and 16 greedy new tokens, through ``ServeEngine`` (4
   slots, max_len 2048, decode_block 4, page 64); the first request
   alone (it records the prefix), then the other seven together. Served
   cold (cache_pages 0), warm with an fp pool and warm with an int8 pool
   (320 pages), A^3 off, and cold / warm fp with A^3 conservative, each
   mode's cold and warm fp serves in turns (cold, warm, warm, cold). Holds:
   warm fp tokens = cold tokens (A^3 off and conservative); the fp pool's
   gathered ring rows 0..1023 bit-equal to the cold serve's; the int8
   pool's dequantized pages within amax/254 of the fp rows in every
   (layer, page, head) block and the warm rings exactly those values in
   bf16; 7168 tokens reused, none evicted, 1536 tokens prefilled against
   8704 cold; ``gather_dispatches`` = the ticks with a warm hit;
   ``host_sync_stalls`` 0; every gather and record call under
   ``set_sync_debug_mode("error")``; #1 32 x decode_steps in the A^3-off
   serves; a repeated serve's tokens = its first's. Prints wall time and
   median time to first token of each seven-request serve and warm / cold
   over the means of each pair, the gather's device ms and
   kernels (4 slots a call), a page record's, pool bytes, peak memory
   above what was held and the int8-against-fp token agreement; (b) the
   tiny float32 TINY, TINY_RG and TINY_XL engines with an fp and an int8
   pool on the card vs the CPU: tokens and prefix counters identical,
   warm hits taken, #1 (#7 for TINY_XL) launched on the card.
11. durable serving state (after [10], on phase 3's model): (a) the L2
   tier: two 1024-token prefixes A and B (seed-made), each request the
   prefix and its own 64-token suffix, 16 greedy new tokens, 4 slots,
   max_len 2048, decode_block 4, page 64; A's first request alone, B's
   first alone (its recording demotes A's pages), three more of A
   together (A's pages promote back), three more of B together; pools
   fp and int8 with A^3 off (25 pages, 4 GiB of L2) and fp with A^3
   conservative (60 pages: its sorted-key leaf snapshots demote too).
   Holds: tokens = the cold serve's (fp) or = the int8 serve whose
   320-page pool evicts nothing (int8); l2_spills and l2_hits >= 1,
   integrity drops 0; every promotion's staging and insert and every
   gather under ``set_sync_debug_mode("error")``; #1 32 x decode_steps
   with A^3 off. Prints each serve's wall time, the demotions' and
   promotions' wall ms, the inserts' device ms, the blocking reads and
   the blob bytes; (b) the same fp serve with the ``restore_corrupt``
   site armed for the last two batches (rate 1, one injection): one
   integrity drop, tokens = cold; (c) checkpoint / restore: phase 3's
   8 requests (request 0 with 4 new tokens, the others 16; prefill
   chunk 32), A^3 off and conservative, checkpointed at a tick with
   requests queued, prefilling and decoding into a temporary directory
   and restored into a fresh engine: tokens, statuses and clock-free
   stats = the uninterrupted serve's; prints arrays.bin bytes and the
   checkpoint and restore seconds; (d) chaos: the corrupt site on (c)'s
   serve (A^3 off and conservative; the victim FAILS off a POISON
   harvest, the others' tokens = chaos-free), the raise and delay sites
   at rate 0.3 (tokens = chaos-free), #1 on NaN lanes of a served ring,
   and the tiny float32 TINY, TINY_RG and TINY_XL engines with the L2
   tier and the crash site (a checkpoint after every tick, a restore
   after each crash) on the card vs the CPU: tokens, clock-free stats
   and chaos events identical, #1 (#7 for TINY_XL) launched.
12. the serving telemetry plane (after [11], on phase 3's model): phase
   3's serve (8 requests of 64-token prompts, 16 greedy new tokens, 4
   slots, max_len 512, decode_block 4), A^3 off and conservative,
   pipeline_depth 0 and 1, each as telemetry off, on with
   telemetry_every 1 and 8, and off again (the wall in turns). Holds:
   tokens and ``host_syncs`` = the telemetry-off serve's,
   ``host_sync_stalls`` 0; ``serve_a3_probe_dispatches`` =
   ceil(decode_dispatches / every) with A^3, 0 without; every probed
   captured mass in [0, 1] and samples > 0; #1 32 x decode_steps in the
   A^3-off serves; a probed dispatch and the harvest of a probed block
   under ``set_sync_debug_mode("error")`` at depth 0 and 1; the Chrome
   trace loads with monotone ``decode_block`` spans per slot, the
   metrics file equals the registry's snapshot, and the CLI's
   ``--stats-json`` (on this model) has the engine's clock-free stats
   and metrics. Prints the median captured mass and candidates per kv
   head at every 1 and 8, one probed A^3 decode step against an
   unprobed one (events, device ms, kernels) and the wall of each serve;
   (b) the tiny float32 TINY (A^3 conservative), TINY_RG and TINY_XL
   engines with telemetry every 2 on the card vs the CPU: tokens,
   clock-free metrics and each request's trace events identical, probe
   rows within 2e-5.
13. training (after [9]; the phi4 model freed first): (a) xlstm-350m at
   full width and depth (bf16, AdamW m/v float32, batch 4 x 512, remat
   full, random weights from seed 0): one batch's grads through
   ``MLSTMChunk`` (#7's forward; its backward recomputes the plain
   version) against the same batch with the chunk loop in its plain
   version on the card (loss and every grad within 2e-2 of max |grad|),
   every mLSTM parameter's grad finite and non-zero, then 4 steps of
   ``train_loop`` on ``SyntheticLM`` with #7 launched 21 x 2 a step (the
   forward and the remat recompute) on its tensor-core route; step ms by
   events, device ms and kernels of a step by the profiler, peak memory,
   tok/s; (b) internlm2-1.8b at full width and depth (bf16, m/v float32,
   ~22 GB of state): 3 steps at remat none and 3 at full from the same
   weights at batch 1 x 2048 (remat none does not fit at 4 x 2048: the
   plain float32 attention keeps ~3 GB of scores a layer), losses within
   1e-3 relative, then 3 steps at 4 x 2048, remat full, ce_chunk 512,
   and the same figures; the model is freed; (c) TINY and TINY_XL
   float32: 4 train steps on the card equal the CPU's losses within 1e-4
   relative from one CPU-drawn init, ``train_with_recovery`` with a crash
   at step 3 equals the uninterrupted run's last loss within 1e-5, #7 on
   its CUDA-core route; (d) MemN2N on bAbI: ``tests/test_memn2n.py``'s
   task (700 steps; exact accuracy > 0.85, A^3 conservative within 0.05
   of it; the batched A^3 form's candidates equal the single-query
   function's), then ``examples/babi_memn2n.py``'s task (600 steps):
   exact accuracy, and per A^3 setting the accuracy, its delta, the mean
   candidates and the captured softmax mass of each hop.
14. the frontend archs from precomputed embeddings (after [13]), each at
   full width and depth with random bf16 weights from seed 0, one model
   on the card at a time: (a) musicgen-medium (48 layers, MHA 24 x 64):
   ``prefill(inputs_embeds=...)`` of B=4 x 1000 stub EnCodec frames
   (``audio_frame_embeds``, a 20 s prompt at 50 Hz), max_len 1064, then
   64 ``decode_step(input_embed=...)`` steps each fed the next frame,
   A^3 off and conservative (``prefill(a3=True)``); (b) internvl2-2b
   (24 layers, Hq 16, Hkv 8, D 128): 256 stub InternViT patches and a
   256-token text prompt (``vlm_sequence``, the text through
   ``embed_tokens``) prefilled at B=4, then 32 greedy
   ``decode_step(token)`` steps, A^3 off and conservative. For each:
   prefill ms and ms a decode step (CUDA events), one step's device busy
   time and kernels (the profiler), #1 once per layer per A^3-off step
   (none with A^3, the compact path), peak memory, and the share of
   (lane, step) argmaxes A^3 conservative shares with off; (c) #1
   against its plain version on 4 layers' rings as each A^3-off run
   left them (phase 9's check: within 2e-2 of max |plain|, masking every
   other key must exceed that), timed beside its plain version, SDPA and
   its bytes bound (musicgen G=1, D=64, S=1064; internvl2 G=2, D=128,
   S=544); (d) musicgen-medium training on ``{"embeds", "labels"}``
   batches, B=4 x 1024, remat full, AdamW m/v float32, 3 steps of
   ``make_train_step``: losses finite, ``embed``'s gradient exactly zero
   (its moments stay 0) and ``embed`` the decay-only AdamW update within
   one bf16 step; step ms, busy share, kernels, peak memory, tok/s; (e)
   both smoke variants in float32 on the card vs the CPU from one
   CPU-drawn init and numpy embeddings: forward, prefill and decode
   logits within 1e-5, internvl2's layout's greedy tokens equal, 2
   embeds train steps' losses within 1e-6 relative; (f)
   ``examples/quickstart_torch.py`` and ``examples/serve_lm_torch.py``
   (its defaults) run on the card and exit 0.
15. the device mesh (after [14]), on a one-rank NCCL ("data", "model")
   mesh (``launch.mesh``; the tool gives one card, NCCL takes one rank a
   card): (a) internlm2-1.8b (B=4 x 2048) and (b) xlstm-350m (B=4 x 512)
   at full width and depth, remat full, 3 steps of the unsharded step
   and 3 of the sharded step (``make_train_step(run, mesh)``: DTensor
   parameters and moments, weights gathered per layer) from the same
   seed and batches, one model on the card at a time: losses within 1e-5
   relative, step ms (CUDA events) and peak memory, #7 launched 2 x 21 a
   sharded xlstm-350m step; (c) on CUDA tensors: ``psum_compressed``
   over a one-rank pod axis (within half a quantization step, mean + err
   = g), ``pipeline_forward`` through one stage (= the stage), a
   compressed sharded TINY step, and a sharded TINY state saved and
   restored bit-equal through the mesh checkpoint path; (d) TINY float32
   on four gloo CPU ranks (a (data 2, model 2) mesh, subprocesses of this
   script started with ``--mesh-rank``) against the card's one-rank
   mesh: 3 sharded steps' losses within 2e-5 relative.

Prints one JSON line of per-kernel numbers (every row with
``device_ms``, the profiler's device time per launch; rows #1-#3 with
``s4096``, the long ring's ms, device ms and bound; row #1 with
``served_shapes``, phase 9's and [14c]'s rows; #1's launches include
[10]'s, [11]'s, [12]'s and [14]'s A^3-off decode steps, #7's [10b]'s,
[11d]'s, [12b]'s, [13]'s ([13a]'s train_loop steps and [13c]'s card
steps) and [15b]'s sharded steps),
then, last,
``{"ok": true, "device": {...}}``. Exits non-zero, with no result line,
when CUDA is unavailable or the port's sources are not beside the script.
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = dict(rtol=2e-2, atol=2e-2)          # bf16, as tests/test_kernels.py
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
BF16_FLOPS = 989e12                       # dense bf16 tensor-core peak
SHAPE = dict(b=4, hq=24, hkv=8, s=512, d=128)
N_SETS = 8                                # 8 x 8.4 MB of K/V > 50 MB of L2
CARD = ""


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cuda_ms(fn, arg_sets, iters):
    """Mean ms per call over ``iters`` calls cycling through
    ``arg_sets``, by CUDA events after a warm-up."""
    import torch
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, arg_sets, iters, per_launch=False):
    """Device time per call by ``torch.profiler``: the self device time
    of every kernel launched over ``iters`` calls cycling through
    ``arg_sets``, over ``iters`` (with ``per_launch``, for a wrapper that
    launches one kernel a call, over the kernel launches the profiler
    recorded); None when the profiler saw no device activity. Beside
    ``cuda_ms`` it separates the kernels' time from the host's
    enqueue."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in dev)
    n = sum(e.count for e in dev) if per_launch else iters
    return total_us / 1e3 / n if total_us > 0 and n > 0 else None


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bound(nbytes, flops):
    """(least ms, what bounds it) for moving ``nbytes`` and doing
    ``flops`` bf16 operations on one H100."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ptxas_report(text):
    """(kernel, "N registers, S bytes spill stores, ...") per function of
    an ``nvcc -Xptxas -v`` log, with ptxas's note where it serialised a
    kernel's wgmma; the kernel is the mangled name's identifier and
    template arguments, shortened."""
    import re

    def shorten(mangled):
        short = re.search(r"([a-z_]+_kernel)I(\w*?)EEv", mangled)
        return f"{short.group(1)}<{short.group(2)}>" if short \
            else mangled[-40:]

    out, name = [], None
    for ln in text.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        serial = re.search(r"\(C7514\).*function '(\S+)'", ln)
        if m:
            name = shorten(m.group(1))
        elif serial:
            out.append((shorten(serial.group(1)),
                        "wgmma serialized by ptxas (C7514)"))
        elif name and ("spill" in ln or "registers" in ln) and \
                "(C75" not in ln:
            out.append((name, ln.strip().replace("ptxas info    : ", "")))
    report = {}
    for fn, props in out:
        report[fn] = (report[fn] + "; " + props) if fn in report else props
    return list(report.items())


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------

def make_inputs(seed, dev, s=None):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    b, hq, hkv, d = (SHAPE[k] for k in ("b", "hq", "hkv", "d"))
    s = s or SHAPE["s"]
    q = torch.randn((b, hq, d), generator=g, device=dev).bfloat16()
    k = torch.randn((b, hkv, s, d), generator=g, device=dev).bfloat16()
    v = torch.randn((b, hkv, s, d), generator=g, device=dev).bfloat16()
    mask = torch.rand((b, hq, s), generator=g, device=dev) < 0.6
    mask[0, hq - 1] = False                   # rows with nothing kept
    mask[b - 1, 0] = False
    return q, k, v, mask


def max_err(got, want):
    """Max |got - want| and whether it is inside the bf16 tolerance."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= TOL["atol"] + TOL["rtol"] * want.abs()).all())
    return float(err.max()), ok


def needed_bytes_flops(q, k, v, mask, keep, out_bytes, extra_in=0):
    """Bytes and operations the function needs on these inputs: q and
    the mask read once, the K rows some query of the group attends to,
    the V rows with a kept weight, the output written once; 2*D
    operations per scored pair and 2*Dv per kept pair."""
    b, hq, d = q.shape
    hkv, dv = k.shape[1], v.shape[3] if v is not None else 0
    g = hq // hkv
    krows = int(mask.reshape(b, hkv, g, -1).any(2).sum())
    vrows = int(keep.reshape(b, hkv, g, -1).any(2).sum()) if v is not None \
        else 0
    nbytes = (q.numel() * 2 + mask.numel() + krows * d * 2 + vrows * dv * 2
              + out_bytes + extra_in)
    flops = 2 * d * int(mask.sum()) + 2 * dv * int(keep.sum())
    return nbytes, flops


def mean_bound(needs):
    """bound() of the mean (bytes, operations) over input sets."""
    nb, fl = zip(*needs)
    return bound(sum(nb) / len(nb), sum(fl) / len(fl))


def decode_keep(q, k, mask, rm, thr):
    """The entries the attend pass keeps: mask & s >= rowmax - thr."""
    import torch
    hq, hkv, d = q.shape[1], k.shape[1], q.shape[2]
    sc = torch.einsum("bhd,bhkd->bhk", q.float(),
                      k.float().repeat_interleave(hq // hkv, 1))
    return mask & (sc * d ** -0.5 >= rm[..., None] - thr)


def decode_bounds(sets, rms, thr):
    """Bounds of #1 (no threshold), #2 and #3 (threshold ``thr``, given
    #2's row maxima ``rms``) over the input sets."""
    b, hq, d = sets[0][0].shape
    out = b * hq * d * 2
    return {
        "fused": mean_bound([needed_bytes_flops(q, k, v, m, m, out)
                             for q, k, v, m in sets]),
        "rowmax": mean_bound([needed_bytes_flops(q, k, None, m, m,
                                                 b * hq * 4)
                              for q, k, v, m in sets]),
        "attend": mean_bound([needed_bytes_flops(
            q, k, v, m, decode_keep(q, k, m, rm, thr), out,
            extra_in=b * hq * 4) for (q, k, v, m), rm in zip(sets, rms)]),
    }


def two_pass_threshold_zero(q, k, v, mask, label):
    """At threshold 0 the attend kernel (#3) keeps exactly the entries
    whose score equals the row-max kernel's (#2) maximum, so every row
    whose mask admits an entry must come back non-zero (V at its argmax),
    in bf16 and float32: both kernels must score q.k into the same
    floats."""
    from repro_torch.kernels.decode_attention import kernel as tk
    admits = mask.any(-1)
    for dtype in ("bf16", "f32"):
        qq, kk, vv = (q, k, v) if dtype == "bf16" else \
            (q.float(), k.float(), v.float())
        out = tk.attend(qq, kk, vv, mask, tk.rowmax(qq, kk, mask),
                        threshold=0.0)
        lost = int(((out == 0).all(-1) & admits).sum())
        check(lost == 0, f"two-pass threshold 0 ({label}, {dtype}): {lost} "
                         f"of {int(admits.sum())} admitting rows came back 0")
    log(f"  two-pass threshold 0 ({label}, bf16 and f32): all "
        f"{int(admits.sum())} admitting rows keep their maximum (non-zero "
        f"output)")


def nan_rows_check(got, want, what):
    """``got`` has ``want``'s NaN rows and all-zero rows (last axis), and
    every other entry within the bf16 tolerance -> max |error| there."""
    import torch
    gn, wn = torch.isnan(got), torch.isnan(want)
    check(torch.equal(gn, wn), f"{what}: NaN entries differ from the plain "
                               f"version's: kernel {int(gn.sum())}, plain "
                               f"{int(wn.sum())}")
    gz, wz = (got == 0).all(-1), (want == 0).all(-1)
    check(torch.equal(gz, wz), f"{what}: zero rows differ from the plain "
                               f"version's: kernel {int(gz.sum())}, plain "
                               f"{int(wz.sum())}")
    e, ok = max_err(got[~wn], want[~wn])
    check(ok, f"{what}: the finite entries next to NaN keys: {e}")
    return e


def nan_lanes(k, v, mask):
    """Copies of k, v, mask with lane 1's key row 5 NaN (V finite) and
    lane 2's ring NaN but its last row (a corrupted cache lane the step
    after its corruption), both admitted by every query head."""
    k, v, mask = k.clone(), v.clone(), mask.clone()
    s = k.shape[2]
    mask[1:3, :, 5] = True
    mask[2, :, s - 1] = True
    k[1, :, 5] = float("nan")
    k[2, :, :s - 1] = float("nan")
    v[2, :, :s - 1] = float("nan")
    return k, v, mask


def fused_nan_check(q, k, v, mask, label):
    """#1 against its plain version on NaN scores (block_k 512 and 128,
    thresholds None and 3.0): lane 1 gets one NaN key row with V finite,
    lane 2 a NaN ring whose last row is finite (a corrupted cache lane
    the step after its corruption). A NaN score propagates into #1's
    running max, as ``jnp.maximum`` does in the Pallas kernel, so the
    NaN rows must be the plain version's (every admitted row of lanes 1
    and 2) and every other row within the bf16 tolerance."""
    import torch
    from repro_torch.kernels.decode_attention import kernel as tk
    k, v, mask = nan_lanes(k, v, mask)
    worst = 0.0
    for thr in (None, 3.0):
        for block_k in (512, 128):
            want = tk.fused_plain(q, k, v, mask, threshold=thr,
                                  block_k=block_k)
            check(bool(torch.isnan(want[1:3]).all()),
                  f"{label}: the plain rows of lanes 1-2 are not all NaN")
            worst = max(worst, nan_rows_check(
                tk.fused(q, k, v, mask, threshold=thr, block_k=block_k),
                want, f"{label}: #1 (thr={thr}, block_k={block_k})"))
    log(f"  #1 on NaN scores ({label}): the NaN rows are the plain "
        f"version's with and without threshold 3.0 (lanes 1-2), the other "
        f"rows within {worst:.3g}")


def two_pass_nan_check(q, k, v, mask, label):
    """#2 and #3 against their plain versions on NaN keys (block_k 512 and
    128, thresholds None and 3.0): lane 1 gets one NaN key row with V
    finite, lane 2 a NaN ring whose last row is finite. A NaN score makes
    #2's row max NaN, as ``jnp.maximum`` does in the Pallas kernel, so
    #3 then keeps nothing of those rows under a threshold (l = 0, a zero
    row) and NaN without one: the NaN and zero rows must be the plain
    versions', the other rows within the bf16 tolerance."""
    import torch
    from repro_torch.kernels.decode_attention import kernel as tk
    k, v, mask = nan_lanes(k, v, mask)
    worst = 0.0
    for block_k in (512, 128):
        rm = tk.rowmax(q, k, mask, block_k=block_k)
        want_rm = tk.rowmax_plain(q, k, mask, block_k=block_k)
        worst = max(worst, nan_rows_check(rm[..., None], want_rm[..., None],
                                          f"{label}: #2 (block_k={block_k})"))
        check(bool(torch.isnan(want_rm[1:3]).all()),
              f"{label}: the plain row max of lanes 1-2 is not NaN")
        for thr in (None, 3.0):
            out = tk.attend(q, k, v, mask, rm, threshold=thr,
                            block_k=block_k)
            want = tk.attend_plain(q, k, v, mask, want_rm, threshold=thr,
                                   block_k=block_k)
            worst = max(worst, nan_rows_check(
                out, want, f"{label}: #3 (thr={thr}, block_k={block_k})"))
            lanes = want[1:3]
            check(bool(torch.isnan(lanes).all() if thr is None
                       else (lanes == 0).all()),
                  f"{label}: #3's plain rows of lanes 1-2 (thr={thr}) are "
                  f"not all {'NaN' if thr is None else 'zero'}")
    log(f"  #2/#3 on NaN keys ({label}): #2's NaN row maxima and #3's NaN "
        f"rows (no threshold) and zero rows (threshold 3.0) are the plain "
        f"versions' (lanes 1-2), the other rows within {worst:.3g}")


def phase_kernels(dev):
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel as tk

    sets = [make_inputs(i, dev) for i in range(N_SETS)]
    q, k, v, mask = sets[0]
    errs = {"fused": 0.0, "rowmax": 0.0, "attend": 0.0}
    for threshold in (None, 3.0):
        for block_k in (512, 128):
            out = tk.fused(q, k, v, mask, threshold=threshold,
                           block_k=block_k)
            e, ok = max_err(out, tk.fused_plain(q, k, v, mask,
                                                threshold=threshold,
                                                block_k=block_k))
            check(ok, f"fused kernel disagrees with its plain version "
                      f"(thr={threshold}, block_k={block_k}): {e}")
            errs["fused"] = max(errs["fused"], e)
            rm = tk.rowmax(q, k, mask, block_k=block_k)
            e, ok = max_err(rm, tk.rowmax_plain(q, k, mask, block_k=block_k))
            check(ok, f"row-max kernel disagrees (block_k={block_k}): {e}")
            errs["rowmax"] = max(errs["rowmax"], e)
            out = tk.attend(q, k, v, mask, rm, threshold=threshold,
                            block_k=block_k)
            e, ok = max_err(out, tk.attend_plain(q, k, v, mask, rm,
                                                 threshold=threshold,
                                                 block_k=block_k))
            check(ok, f"attend kernel disagrees (thr={threshold}, "
                      f"block_k={block_k}): {e}")
            errs["attend"] = max(errs["attend"], e)
            log(f"  kernels vs plain thr={threshold} block_k={block_k}: "
                f"max_abs_err fused {errs['fused']:.3g} rowmax "
                f"{errs['rowmax']:.3g} attend {errs['attend']:.3g} "
                f"(tolerance atol {TOL['atol']} + rtol {TOL['rtol']})")
    two_pass_threshold_zero(q, k, v, mask, f"S={SHAPE['s']}")
    fused_nan_check(q, k, v, mask, f"S={SHAPE['s']} bf16")
    two_pass_nan_check(q, k, v, mask, f"S={SHAPE['s']} bf16")
    two_pass_nan_check(q.float(), k.float(), v.float(), mask,
                       f"S={SHAPE['s']} f32")
    sync(dev)

    # timed configuration: each kernel as its path calls it (block_k 512;
    # the fused kernel without threshold as A^3-off decode; the two-pass
    # pair with the conservative threshold)
    thr = 3.0
    rms = [tk.rowmax(*(s_[0], s_[1], s_[3])) for s_ in sets]
    sdpa_sets = [(x[0][:, :, None], x[1], x[2], x[3][:, :, None])
                 for x in sets]

    def sdpa(q4, k4, v4, m4):
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4,
                                              enable_gqa=True)

    bounds = decode_bounds(sets, rms, thr)
    res = {}
    res["fused"] = dict(
        ms=cuda_ms(lambda *x: tk.fused(*x), sets, 200),
        plain_ms=cuda_ms(lambda *x: tk.fused_plain(*x), sets, 20),
        library_ms=cuda_ms(sdpa, sdpa_sets, 200), bound=bounds["fused"],
        device_ms=device_ms(lambda *x: tk.fused(*x), sets, 200, True),
        library_device_ms=device_ms(sdpa, sdpa_sets, 200))
    log(f"  fused: cluster of {tk.cluster_size(SHAPE['s'], 512)} CTAs per "
        f"(batch, kv head); two-pass: cluster of "
        f"{tk.two_pass_cluster_size(SHAPE['s'])}; "
        f"{SHAPE['b'] * SHAPE['hkv']} clusters each")
    rsets = [(x[0], x[1], x[3]) for x in sets]
    res["rowmax"] = dict(
        ms=cuda_ms(lambda *x: tk.rowmax(*x), rsets, 200),
        plain_ms=cuda_ms(lambda *x: tk.rowmax_plain(*x), rsets, 20),
        library_ms=None, bound=bounds["rowmax"],
        device_ms=device_ms(lambda *x: tk.rowmax(*x), rsets, 200, True))
    asets = [(x[0], x[1], x[2], x[3], rm) for x, rm in zip(sets, rms)]
    res["attend"] = dict(
        ms=cuda_ms(lambda *x: tk.attend(*x, threshold=thr), asets, 200),
        plain_ms=cuda_ms(lambda *x: tk.attend_plain(*x, threshold=thr),
                         asets, 20),
        library_ms=None, bound=bounds["attend"],
        device_ms=device_ms(lambda *x: tk.attend(*x, threshold=thr), asets,
                            200, True))
    for name, r in res.items():
        lib = ("not applicable" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        log(f"  {name}: kernel {r['ms']:.4f} ms, device "
            f"{fmt_ms(r['device_ms'])}, plain {r['plain_ms']:.4f} ms, "
            f"library {lib}, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]}) [{CARD}]")
    r = res["fused"]
    log(f"  fused by device time per launch (torch.profiler): kernel "
        f"{fmt_ms(r['device_ms'])}, SDPA {fmt_ms(r['library_device_ms'])}; "
        f"by the event loop: kernel {r['ms']:.4f} ms, SDPA "
        f"{r['library_ms']:.4f} ms [{CARD}]")
    for name, r in phase_long_ring(dev, errs, thr).items():
        res[name]["s4096"] = r
    return errs, res


LONG_S = 4096              # a long ring: 67 MB of K/V a set, > 50 MB of L2
N_LONG_SETS = 2


def phase_long_ring(dev, errs, thr):
    """[2] at S=4096: #1-#3 against their plain versions once (block_k
    512; #1 without threshold, the pair at ``thr``) and the threshold-0
    check, then each kernel by events and by device time per launch
    beside its bound (the plain versions are not timed)."""
    from repro_torch.kernels.decode_attention import kernel as tk
    sets = [make_inputs(50 + i, dev, s=LONG_S) for i in range(N_LONG_SETS)]
    q, k, v, mask = sets[0]
    rm = tk.rowmax(q, k, mask)
    for name, got, want in (
            ("fused", tk.fused(q, k, v, mask), tk.fused_plain(q, k, v, mask)),
            ("rowmax", rm, tk.rowmax_plain(q, k, mask)),
            ("attend", tk.attend(q, k, v, mask, rm, threshold=thr),
             tk.attend_plain(q, k, v, mask, rm, threshold=thr))):
        e, ok = max_err(got, want)
        check(ok, f"{name} kernel disagrees with its plain version at "
                  f"S={LONG_S}: {e}")
        errs[name] = max(errs[name], e)
    log(f"  S={LONG_S} vs plain: max_abs_err (all shapes so far) fused "
        f"{errs['fused']:.3g} rowmax {errs['rowmax']:.3g} attend "
        f"{errs['attend']:.3g}; clusters: fused "
        f"{tk.cluster_size(LONG_S, 512)}, two-pass "
        f"{tk.two_pass_cluster_size(LONG_S)}")
    two_pass_threshold_zero(q, k, v, mask, f"S={LONG_S}")
    rms = [tk.rowmax(x[0], x[1], x[3]) for x in sets]
    bounds = decode_bounds(sets, rms, thr)
    calls = {
        "fused": (lambda *x: tk.fused(*x), sets),
        "rowmax": (lambda *x: tk.rowmax(*x), [(x[0], x[1], x[3])
                                               for x in sets]),
        "attend": (lambda *x: tk.attend(*x, threshold=thr),
                   [(*x, rm) for x, rm in zip(sets, rms)]),
    }
    res = {}
    for name, (fn, args) in calls.items():
        r = res[name] = dict(ms=cuda_ms(fn, args, 50),
                             device_ms=device_ms(fn, args, 50, True),
                             bound_ms=bounds[name][0],
                             bound_by=bounds[name][1])
        share = "" if r["device_ms"] is None else \
            f", {r['device_ms'] / r['bound_ms']:.2f}x the bound"
        log(f"  S={LONG_S} {name}: kernel {r['ms']:.4f} ms by events, "
            f"{fmt_ms(r['device_ms'])} device, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}){share} [{CARD}]")
    return res


# ---------------------------------------------------------------------------
# phases 3-4: full-width serving
# ---------------------------------------------------------------------------

def serve_run(model, cfg, prompts, a3, decode_block, max_new,
              on_engine=None, **knobs):
    """Serve ``prompts`` to the end on a fresh engine (4 slots, max_len
    512; ``on_engine(eng)`` runs before the first submit) -> (results,
    engine, wall s, kernel launches of the run)."""
    from repro_torch.kernels.decode_attention import kernel as tk
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(model, cfg, slots=4, max_len=512, a3=a3,
                      decode_block=decode_block, **knobs)
    if on_engine is not None:
        on_engine(eng)
    uids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    sync(model.device)
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run_to_completion()
    sync(model.device)
    dt = time.perf_counter() - t0
    launches = dict(tk.LAUNCHES)
    outs = [eng.result(u) for u in uids]
    check(all(o is not None and len(o) == max_new for o in outs),
          "a request did not finish with its full budget")
    check(all(0 <= t < cfg.vocab_size for o in outs for t in o),
          "a generated token lies outside the vocabulary")
    return outs, eng, dt, launches


def step_fn(model, cfg, a3, use_a3):
    """One decode_step closure: 4 lanes at position 80 of a 512-row
    ring."""
    import torch
    from repro_torch.models import decoder
    dev = model.device
    cache = decoder.init_cache(cfg, 4, 512, a3=use_a3, device=dev)
    tok = torch.arange(4, dtype=torch.int32, device=dev)
    pos = torch.full((4,), 80, dtype=torch.int32, device=dev)
    return lambda: decoder.decode_step(model, cfg, cache, tok, pos, a3=a3)


def profile_steps(fn, steps=3, op=None):
    """Device time per step from torch.profiler over ``steps`` calls:
    (device ms per step, kernels per step, top kernels as (name, ms per
    step), device ms per step of the kernels launched under the CPU op
    ``op``, e.g. "aten::bmm", or None); device ms is None when the
    profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    dev = [e for e in avg if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in dev)
    if not dev or total_us <= 0:
        return None, 0, [], None
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    op_us = sum(e.device_time_total for e in avg
                if e.device_type == DeviceType.CPU and e.key == op)
    return (total_us / 1e3 / steps, sum(e.count for e in dev) / steps,
            [(e.key[:60], e.self_device_time_total / 1e3 / steps)
             for e in top], op_us / 1e3 / steps if op_us > 0 else None)


def profile_named(fn, name, steps=2):
    """(device ms per call, kernels per call, device ms per call of the
    kernels whose name contains ``name``) by torch.profiler over
    ``steps`` calls after a warm-up; (None, 0, 0) when the profiler saw
    no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in dev)
    if not dev or total_us <= 0:
        return None, 0, 0.0
    named = sum(e.self_device_time_total for e in dev if name in e.key)
    return (total_us / 1e3 / steps, sum(e.count for e in dev) / steps,
            named / 1e3 / steps)


def phase_serve(dev, cfg):
    import numpy as np
    import torch
    from repro_torch.config import A3Config
    from repro_torch.models import decoder

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = decoder.init_params(cfg, gen, dev)
    sync(dev)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {cfg.name}: {n_params / 1e9:.3f} B params ({cfg.dtype}), "
        f"random init from seed 0 in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=64) for _ in range(8)]
    # warm-up (cuBLAS handles, first launches), not measured
    serve_run(model, cfg, prompts[:1], A3Config(), 1, 2)

    runs, main_launches, ring = {}, 0, None
    for mode, a3 in (("off", A3Config()),
                     ("conservative", A3Config.conservative())):
        for t in (1, 4):
            outs, eng, dt, launches = serve_run(model, cfg, prompts, a3, t,
                                                16)
            st = eng.stats
            n_new = sum(len(o) for o in outs)
            line = (f"  serve a3={mode} decode_block={t}: {n_new} tokens in "
                    f"{dt:.3f} s = {n_new / dt:.1f} tok/s; decode_steps "
                    f"{st['decode_steps']}, decode_dispatches "
                    f"{st['decode_dispatches']}, prefill_dispatches "
                    f"{st['prefill_dispatches']}, host_syncs "
                    f"{st['host_syncs']}, resorts {st['resorts']}; kernel "
                    f"launches {launches}")
            if mode == "off":
                want = cfg.num_layers * st["decode_steps"]
                got = launches["decode_attention_fused"]
                check(got == want > 0 or dev.type != "cuda",
                      f"fused kernel launched {got} times, expected "
                      f"{cfg.num_layers} x decode_steps = {want}")
                main_launches += launches["decode_attention_fused"]
                ring = eng.cache["seg0"]
            else:
                ref = runs[("off", t)]["outs"]
                agree = sum(a == b for o, r in zip(outs, ref)
                            for a, b in zip(o, r))
                total = sum(len(r) for r in ref)
                line += (f"; greedy tokens agreeing with A^3 off: "
                         f"{agree}/{total} = {agree / total:.3f}")
            log(line + f" [{CARD}]")
            runs[(mode, t)] = dict(outs=outs, tok_s=n_new / dt,
                                   stats=dict(st), launches=launches)
    for mode, a3 in (("off", A3Config()),
                     ("conservative", A3Config.conservative())):
        fn = step_fn(model, cfg, a3, mode != "off")
        ms = cuda_ms(fn, [()], 20)
        log(f"  decode_step a3={mode}: {ms:.3f} ms per step (B=4, "
            f"max_len 512, {cfg.num_layers} layers) [{CARD}]")
        if dev.type != "cuda":
            continue
        dev_ms, n_kernels, top, _ = profile_steps(fn)
        if dev_ms is None:
            log("    device time per step: not measured (the profiler "
                "saw no device activity)")
            continue
        log(f"    profiler: device busy {dev_ms:.3f} ms per step "
            f"({dev_ms / ms:.1%} of the {ms:.3f} ms step), "
            f"{n_kernels:.0f} kernels per step; top: "
            + "; ".join(f"{n} {t:.3f} ms" for n, t in top))
    if dev.type == "cuda":
        log(f"  peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return runs, main_launches, ring, model


def engine_line(label, outs, eng, dt):
    st = eng.stats
    n_new = sum(len(o) for o in outs)
    split = ", ".join(f"{k[8:]} {st[k] / 1e6:.1f}" for k in
                      ("tick_ns_prefill", "tick_ns_decode",
                       "tick_ns_harvest", "tick_ns_host"))
    log(f"  {label}: {n_new} tokens in {dt:.3f} s = {n_new / dt:.1f} tok/s; "
        f"ticks {st['ticks']}, decode_dispatches {st['decode_dispatches']}, "
        f"host_syncs {st['host_syncs']}, host_sync_stalls "
        f"{st['host_sync_stalls']}; tick ms: {split} [{CARD}]")
    return n_new / dt


def check_conservation(eng):
    s = eng.stats
    check(s["submitted"] == s["finished"] + s["rejected"] + s["cancelled"]
          + s["expired"] + s["failed"] + eng.in_flight,
          f"conservation identity broken: {s}, in_flight {eng.in_flight}")


def phase_engine(model, cfg, dev):
    """[3b]: phi4-mini-3.8b's serve (phase 3's requests, A^3 off,
    decode_block 4) through the engine's pipelined harvest and tempered
    sampling; one depth-1 tick under ``set_sync_debug_mode("error")``; a
    lifecycle run at depth 1 -> kernel #1's launches in its serves."""
    import numpy as np
    import torch
    from repro_torch.config import A3Config
    from repro_torch.models import decoder, sampling
    from repro_torch.serve.engine import ServeEngine

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=64) for _ in range(8)]
    fused, runs = 0, {}

    def serve(label, decode_block, **knobs):
        nonlocal fused
        outs, eng, dt, launches = serve_run(model, cfg, prompts, A3Config(),
                                            decode_block, 16, **knobs)
        want = cfg.num_layers * eng.stats["decode_steps"]
        got = launches["decode_attention_fused"]
        check(got == want > 0, f"{label}: fused kernel launched {got} times, "
                               f"expected {cfg.num_layers} x decode_steps = "
                               f"{want}")
        fused += got
        runs[label] = (outs, engine_line(label, outs, eng, dt))
        return outs

    greedy0 = serve("greedy depth 0", 4, pipeline_depth=0)
    greedy1 = serve("greedy depth 1", 4, pipeline_depth=1)
    check(greedy1 == greedy0, "pipeline_depth 1 changed the greedy tokens")
    sampled = {t: serve(f"T=0.8 depth 1 decode_block {t}", t,
                        pipeline_depth=1, temperature=0.8, sample_seed=0)
               for t in (1, 4)}
    check(sampled[1] == sampled[4], "sampled tokens differ between "
                                    "decode_block 1 and 4")
    check(sampled[4] != greedy1, "temperature 0.8 drew the greedy tokens")
    # greedy and sampled in turns (greedy, sampled, sampled, greedy)
    again = serve("T=0.8 depth 1 decode_block 4 (again)", 4,
                  pipeline_depth=1, temperature=0.8, sample_seed=0)
    check(again == sampled[4], "a repeated sampled serve drew other tokens")
    serve("greedy depth 1 (again)", 4, pipeline_depth=1)
    g = [runs[k][1] for k in ("greedy depth 1", "greedy depth 1 (again)")]
    t = [runs[k][1] for k in ("T=0.8 depth 1 decode_block 4",
                              "T=0.8 depth 1 decode_block 4 (again)")]
    log(f"  decode_block 4, depth 1, in turns: greedy {g[0]:.1f} / "
        f"{g[1]:.1f} tok/s, sampled {t[0]:.1f} / {t[1]:.1f} tok/s [{CARD}]")
    # the draw's cost on the device: one 4-step decode block, greedy and
    # sampled, under the profiler
    busy = {}
    for label, knobs in (("greedy", {}), ("T=0.8", dict(
            temperature=0.8, key=sampling.prng_key(0, dev)))):
        cache = decoder.init_cache(cfg, 4, 512, device=dev)
        tok = torch.arange(4, dtype=torch.int32, device=dev)
        pos = torch.full((4,), 80, dtype=torch.int32, device=dev)
        left = torch.full((4,), 4, dtype=torch.int32, device=dev)

        def block(cache=cache, tok=tok, pos=pos, left=left, knobs=knobs):
            decoder.decode_block(model, cfg, cache, tok, pos, left, steps=4,
                                 sample_ids=tok, **knobs)

        ms = cuda_ms(block, [()], 3)
        dev_ms, n_kernels, _, _ = profile_steps(block, steps=2)
        check(dev_ms is not None, "the profiler saw no device activity")
        busy[label] = (dev_ms, n_kernels)
        log(f"  decode_block(steps=4) {label}: {ms:.3f} ms by events, device "
            f"busy {dev_ms:.3f} ms over {n_kernels:.0f} kernels [{CARD}]")
    log(f"  sampling adds {(busy['T=0.8'][0] - busy['greedy'][0]) / 4:.3f} "
        f"ms of device time and "
        f"{(busy['T=0.8'][1] - busy['greedy'][1]) / 4:.0f} kernels a step "
        f"[{CARD}]")

    # one steady depth-1 decode tick (drain + dispatch) with every
    # synchronizing CUDA call turned into an error
    eng = ServeEngine(model, cfg, slots=4, max_len=512, decode_block=4,
                      pipeline_depth=1)
    for p in prompts[:4]:
        eng.submit(p, max_new_tokens=16)
    eng.step()
    eng.step()
    check(all(s.decoding and s.pending for s in eng.slots),
          "no steady pipelined decode after two ticks")
    before = dict(eng.stats)
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(eng.stats["decode_dispatches"] == before["decode_dispatches"] + 1
          and eng.stats["prefill_dispatches"] == before["prefill_dispatches"],
          "the checked tick was not one decode dispatch")
    log(f"  one depth-1 decode tick under set_sync_debug_mode('error'): no "
        f"synchronizing call (host_syncs {before['host_syncs']} -> "
        f"{eng.stats['host_syncs']}, the harvest read waits on its event)")
    eng.run_to_completion()
    check([eng.result(u) for u in range(4)] == greedy0[:4],
          "the checked engine's tokens differ from the depth-0 serve")

    # lifecycle at depth 1: cancel mid-decode, a 3-tick deadline, drain
    eng = ServeEngine(model, cfg, slots=4, max_len=512, decode_block=4,
                      pipeline_depth=1)
    uids = [eng.submit(p, max_new_tokens=16,
                       deadline_ticks=3 if i == 1 else None)
            for i, p in enumerate(prompts)]
    eng.step()
    check_conservation(eng)
    eng.step()
    check_conservation(eng)
    check(eng.status(uids[0]) == "decoding" and eng.cancel(uids[0]),
          "could not cancel a decoding request")
    eng.drain()
    late = eng.submit(prompts[0], max_new_tokens=4)
    while eng.in_flight:
        eng.step()
        check_conservation(eng)
    statuses = [eng.status(u) for u in uids]
    want = (["cancelled", "expired", "finished", "finished"]
            + ["cancelled"] * 4)
    check(statuses == want and eng.status(late) == "rejected",
          f"lifecycle statuses {statuses}, late submit {eng.status(late)}")
    check([eng.result(u) for u in uids[2:4]] == greedy0[2:4],
          "finished requests' tokens differ from the depth-0 serve")
    log(f"  lifecycle at depth 1: statuses {statuses}, late submit "
        f"{eng.status(late)}; conservation held after each of "
        f"{eng.stats['ticks']} ticks")
    return fused


# ---------------------------------------------------------------------------
# phase 10: the paged prefix cache at phi4-mini width
# ---------------------------------------------------------------------------

PREFIX_LEN, SUFFIX_LEN, PREFIX_PAGE = 1024, 64, 64


def strict_sync(pc, calls):
    """Run ``pc``'s gather and record calls under
    ``set_sync_debug_mode("error")`` (a synchronizing CUDA call in them
    raises), counting them in ``calls``."""
    import torch

    def wrap(name, fn):
        def run(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run

    for name in ("gather_into", "record_boundary", "record_final"):
        setattr(pc, name, wrap(name, getattr(pc, name)))


def prefix_serve(model, cfg, prompts, a3, capture=None, **knobs):
    """Serve ``prompts[0]`` alone (it records the prefix), then the other
    seven together, through ``ServeEngine`` (4 slots, max_len 2048,
    decode_block 4, 16 new tokens) -> dict of the results, the engine,
    the seven-request serve's wall s and times to first token, the
    ticks with a warm hit, #1's launches, the strict-sync call counts and
    the peak memory above what was held. ``capture(uid, k, v)`` gets
    each request's ring rows 0..1023 (every layer, views) once its
    prefill has passed them."""
    import torch
    from repro_torch.kernels.decode_attention import kernel as tk
    from repro_torch.serve.engine import ServeEngine

    dev = model.device
    sync(dev)
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    eng = ServeEngine(model, cfg, slots=4, max_len=2048, a3=a3,
                      decode_block=4, page_size=PREFIX_PAGE, **knobs)
    calls = {}
    if eng._pc is not None:
        strict_sync(eng._pc, calls)
    seen, first, warm_ticks = set(), {}, 0

    def tick(t0):
        nonlocal warm_ticks
        hits = eng.stats["prefix_hits"]
        eng.step()
        warm_ticks += eng.stats["prefix_hits"] > hits
        now = time.perf_counter()
        for si, s in enumerate(eng.slots):
            if not s.active:
                continue
            if s.generated and s.uid not in first:
                first[s.uid] = now - t0
            if s.cursor >= PREFIX_LEN and s.uid not in seen:
                seen.add(s.uid)
                if capture is not None:
                    sc = eng.cache["seg0"]
                    capture(s.uid, sc["k"][:, si, :, :PREFIX_LEN],
                            sc["v"][:, si, :, :PREFIX_LEN])

    tk.reset_launch_counts()
    uids = [eng.submit(prompts[0], max_new_tokens=16)]
    t0 = time.perf_counter()
    while eng.in_flight:
        tick(t0)
    uids += [eng.submit(p, max_new_tokens=16) for p in prompts[1:]]
    sync(dev)
    t0 = time.perf_counter()
    while eng.in_flight:
        tick(t0)
    sync(dev)
    wall = time.perf_counter() - t0
    outs = [eng.result(u) for u in uids]
    check(all(o is not None and len(o) == 16 for o in outs)
          and seen == set(uids), "a prefix-cache request did not finish "
                                 "with its budget, or its rows were not read")
    ttft = sorted(first[u] for u in uids[1:])
    return dict(outs=outs, eng=eng, wall=wall, ttft=ttft,
                warm_ticks=warm_ticks,
                fused=tk.LAUNCHES["decode_attention_fused"], calls=calls,
                peak=(torch.cuda.max_memory_allocated(dev) - held) / 2**30)


def pool_bytes(pc):
    return sum(t.numel() * t.element_size() for seg in pc.pool.values()
               for t in seg.values())


def int8_prefix_rows(pc, prompt):
    """The int8 pool's pages of ``prompt``'s matched prefix, dequantized
    in float32 -> (k, v) [L, Hkv, 1024, D]."""
    import torch
    t, node = pc.lookup(prompt)
    check(t == PREFIX_LEN, f"int8 pool matched {t} tokens, not {PREFIX_LEN}")
    pids = []
    while node is not pc.root:
        pids.append(node.page_id)
        node = node.parent
    pids = torch.tensor(pids[::-1], device=pc.device)
    out = []
    for name in ("k", "v"):
        pages = pc.pool["seg0"][name][:, pids].float()    # [L,P,H,ps,D]
        scale = pc.pool["seg0"][f"{name}_scale"][:, pids]  # [L,P,H,1,1]
        deq = (pages * scale).permute(0, 2, 1, 3, 4)
        out.append(deq.reshape(deq.shape[0], deq.shape[1], PREFIX_LEN, -1))
    return out


def phase_prefix(model, cfg, dev):
    """[10]: phi4-mini-3.8b (the model [3] built) with 8 requests that
    share a 1024-token prefix, each with its own 64-token suffix (16 new
    tokens, greedy): cold (cache_pages 0), warm with an fp pool and warm
    with an int8 pool (page 64, 320 pages), A^3 off, and cold / warm fp
    with A^3 conservative, each mode's cold and warm fp serves in turns
    -> kernel #1's launches in its serves."""
    import numpy as np
    import torch
    from repro_torch.config import A3Config

    rng = np.random.default_rng(10)
    prefix = rng.integers(0, cfg.vocab_size, size=PREFIX_LEN)
    prompts = [np.concatenate([prefix, rng.integers(
        0, cfg.vocab_size, size=SUFFIX_LEN)]) for _ in range(8)]
    off, cons = A3Config(), A3Config.conservative()
    cold_rows, int8_rows = {}, {}

    def keep_in(rows):
        def capture(uid, k, v):
            rows[uid] = (k.clone(), v.clone())
        return capture

    def same_rows(uid, k, v):
        ck, cv = cold_rows[uid]
        check(torch.equal(k, ck) and torch.equal(v, cv),
              f"request {uid}: the fp pool's gathered rows 0..1023 differ "
              f"from the cold serve's")

    # each mode's cold and warm serves in turns (cold, warm, warm, cold;
    # the int8 pool after A^3 off's first warm serve): the serves are
    # host-bound, and the host's pace moves between calls and in a call
    fp, i8 = dict(cache_pages=320), dict(cache_pages=320, kv_quant="int8")
    plan = [("cold off", off, keep_in(cold_rows), {}),
            ("fp off", off, same_rows, fp),
            ("int8 off", off, keep_in(int8_rows), i8),
            ("fp off", off, same_rows, fp),
            ("cold off", off, None, {}),
            ("cold conservative", cons, None, {}),
            ("fp conservative", cons, same_rows, fp),
            ("fp conservative", cons, same_rows, fp),
            ("cold conservative", cons, None, {})]
    runs, fused = {}, 0
    for label, a3, capture, knobs in plan:
        r = prefix_serve(model, cfg, prompts, a3, capture=capture, **knobs)
        st, eng = r["eng"].stats, r["eng"]
        warm = eng._pc is not None
        ttft = r["ttft"]
        again = " (again)" if label in runs else ""
        log(f"  {label}{again}: 7-request serve {r['wall']:.3f} s wall, "
            f"time to first token median {ttft[3]:.3f} s (min "
            f"{ttft[0]:.3f}, max {ttft[-1]:.3f}); prefill_tokens "
            f"{st['prefill_tokens']}, prefill_dispatches "
            f"{st['prefill_dispatches']}, prefix_hits {st['prefix_hits']}, "
            f"prefix_tokens_reused {st['prefix_tokens_reused']}, "
            f"gather_dispatches {st['gather_dispatches']} (ticks with a "
            f"warm hit {r['warm_ticks']}), pages_recorded "
            f"{st['pages_recorded']}, pages_evicted {st['pages_evicted']}, "
            f"pages_in_use {eng._pc.pages_in_use if warm else 0}, "
            f"host_syncs {st['host_syncs']}, host_sync_stalls "
            f"{st['host_sync_stalls']}; #1 launches {r['fused']}; peak "
            f"memory above held {r['peak']:.2f} GiB [{CARD}]")
        if label.endswith("off"):
            want = cfg.num_layers * st["decode_steps"]
            check(r["fused"] == want > 0, f"{label}: #1 launched "
                  f"{r['fused']} times, expected {want}")
            fused += r["fused"]
        if warm:
            check(st["prefix_tokens_reused"] == 7 * PREFIX_LEN
                  and st["pages_evicted"] == 0
                  and st["prefill_tokens"] == (PREFIX_LEN + SUFFIX_LEN
                                               + 7 * SUFFIX_LEN),
                  f"{label}: reuse / eviction / prefill counts {st}")
            check(st["gather_dispatches"] == r["warm_ticks"] > 0,
                  f"{label}: gather_dispatches {st['gather_dispatches']} "
                  f"against {r['warm_ticks']} ticks with a warm hit")
            check(st["host_sync_stalls"] == 0,
                  f"{label}: host_sync_stalls {st['host_sync_stalls']}")
            check(r["calls"].get("gather_into", 0) == r["warm_ticks"]
                  and r["calls"].get("record_boundary", 0) > 0,
                  f"{label}: strict-sync calls {r['calls']}")
            log(f"    gather and record under set_sync_debug_mode('error')"
                f": {r['calls']} calls, no synchronizing call")
        else:
            check(st["prefill_tokens"] == 8 * (PREFIX_LEN + SUFFIX_LEN),
                  f"{label}: prefill_tokens {st['prefill_tokens']}")
        if again:
            check(r["outs"] == runs[label][0]["outs"],
                  f"{label}: a repeated serve gave other tokens")
            del r["eng"]                # keep one engine of each label
        runs.setdefault(label, []).append(r)
    for mode in ("off", "conservative"):
        check(runs[f"fp {mode}"][0]["outs"]
              == runs[f"cold {mode}"][0]["outs"],
              f"A^3 {mode}: warm fp tokens differ from cold tokens")
    log(f"  warm fp tokens = cold tokens for all 8 requests, A^3 off and "
        f"conservative; fp-pool rows 0..1023 bit-equal to the cold serve's "
        f"for all 8, in every warm fp serve")
    def mean(rs, key):
        return sum(key(r) for r in rs) / len(rs)

    for mode in ("off", "conservative"):
        c, w = runs[f"cold {mode}"], runs[f"fp {mode}"]
        turns = (c[0], w[0], w[1], c[1])
        walls = " / ".join(f"{r['wall']:.3f}" for r in turns)
        firsts = " / ".join(f"{r['ttft'][3]:.3f}" for r in turns)
        wall = mean(w, lambda r: r["wall"]) / mean(c, lambda r: r["wall"])
        first = (mean(w, lambda r: r["ttft"][3])
                 / mean(c, lambda r: r["ttft"][3]))
        log(f"  A^3 {mode}, in turns (cold, warm, warm, cold): wall "
            f"{walls} s; median time to first token {firsts} s; warm / "
            f"cold (means of each pair) wall {wall:.3f}, median time to "
            f"first token {first:.3f} [{CARD}]")
    runs = {label: rs[0] for label, rs in runs.items()}

    # the int8 pool: dequantized pages within amax/254 of the fp rows, and
    # the gathered ring rows exactly those values in the ring's dtype
    pc8 = runs["int8 off"]["eng"]._pc
    dk, dv = int8_prefix_rows(pc8, prompts[1])
    worst = 0.0
    for uid, (gk, gv) in int8_rows.items():
        ck, cv = cold_rows[uid]
        for got, deq, fp in ((gk, dk, ck), (gv, dv, cv)):
            f = fp.float()
            pages = f.reshape(f.shape[0], f.shape[1], -1, PREFIX_PAGE,
                              f.shape[-1])
            amax = pages.abs().amax(dim=(3, 4), keepdim=True)
            err = (deq.reshape(pages.shape) - pages).abs()
            worst = max(worst, float((err / (amax / 254.0)).max()))
            if uid > 0:
                check(torch.equal(got, deq.to(got.dtype)),
                      f"request {uid}: int8 ring rows are not the pool's "
                      f"dequantized pages")
    check(worst <= 1.0 + 1e-5, f"int8 pool rows exceed amax/254: "
          f"{worst:.6f} of the bound")
    agree = sum(a == b for o, r in zip(runs["int8 off"]["outs"],
                                       runs["fp off"]["outs"])
                for a, b in zip(o, r))
    pc = runs["fp off"]["eng"]._pc
    log(f"  int8 pool: dequantized rows within {worst:.4f} x amax/254 of "
        f"the fp rows (every (layer, page, head) block, 8 requests); the "
        f"7 warm rings are those values in bf16; int8 vs fp warm greedy "
        f"tokens agree {agree}/128; pool bytes fp {pool_bytes(pc)} / int8 "
        f"{pool_bytes(pc8)} = {pool_bytes(pc) / pool_bytes(pc8):.3f}")

    # device cost of one gather (4 slots restored) and of recording a page
    for label in ("fp off", "fp conservative", "int8 off"):
        eng = runs[label]["eng"]
        epc = eng._pc
        t, node = epc.lookup(prompts[1])
        entries = [(si, t, node) for si in range(4)]
        ms = cuda_ms(lambda: epc.gather_into(eng.cache, entries), [()], 5)
        dev_ms, n_kernels, _ = profile_named(
            lambda: epc.gather_into(eng.cache, entries), "", steps=3)
        page = epc._free[-1]
        rec_ms = cuda_ms(lambda: epc._record_page(eng.cache, 0, page,
                                                  PREFIX_LEN), [()], 20)
        rdev, rkernels, _ = profile_named(
            lambda: epc._record_page(eng.cache, 0, page, PREFIX_LEN), "",
            steps=5)
        log(f"  {label}: gather_into(4 slots x {t} tokens) {ms:.3f} ms by "
            f"events, device {fmt_ms(dev_ms)} over {n_kernels:.0f} kernels "
            f"a call; record one page {rec_ms:.4f} ms by events, device "
            f"{fmt_ms(rdev)} over {rkernels:.0f} kernels [{CARD}]")
    return fused


def phase_prefix_tiny(dev):
    """[10b]: the tiny float32 TINY, TINY_RG and TINY_XL engines with an
    fp and an int8 pool (page 8, chunk 8, 32 pages; three prompts that
    share 24 tokens, the first served alone) on the card vs the CPU:
    greedy tokens and prefix counters identical, warm hits taken, #1 on
    the card for the attention configs -> #7's launches on the card."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.config import A3Config, AttentionKind, BlockKind, \
        ModelConfig
    from repro_torch.kernels.decode_attention import kernel as tk
    from repro_torch.kernels.mlstm_chunk import kernel as mk
    from repro_torch.models import decoder
    from repro_torch.serve.engine import ServeEngine

    tiny = ModelConfig("tiny", "dense", num_layers=2, d_model=64,
                       num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                       head_dim=16, dtype="float32")
    configs = {
        "TINY": tiny,
        "TINY_RG": dataclasses.replace(
            tiny, name="tiny-rg", num_layers=3,
            attention_kind=AttentionKind.SLIDING, window_size=24,
            block_pattern=(BlockKind.RGLRU, BlockKind.RGLRU,
                           BlockKind.ATTENTION), act="gelu"),
        "TINY_XL": dataclasses.replace(
            tiny, name="tiny-xl", family="ssm", num_layers=3,
            num_kv_heads=4, d_ff=0,
            block_pattern=(BlockKind.MLSTM, BlockKind.MLSTM,
                           BlockKind.SLSTM)),
    }
    rng = np.random.default_rng(7)
    shared = rng.integers(0, 256, size=24)
    prompts = [np.concatenate([shared, rng.integers(0, 256, size=4 + 3 * i)])
               for i in range(3)]
    keys = ("prefix_hits", "prefix_tokens_reused", "gather_dispatches",
            "pages_recorded", "prefill_tokens", "prefill_dispatches")
    mlstm = 0
    for name, cfg in configs.items():
        cpu = decoder.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
        gpu = copy.deepcopy(cpu).to(dev)
        for kv_quant in ("none", "int8"):
            outs, stats = {}, {}
            for where, model in (("cpu", cpu), ("cuda", gpu)):
                eng = ServeEngine(model, cfg, slots=2, max_len=96,
                                  a3=A3Config(), prefill_chunk=8,
                                  decode_block=4, page_size=8,
                                  cache_pages=32, kv_quant=kv_quant)
                tk.reset_launch_counts()
                mk.reset_launch_counts()
                u0 = eng.submit(prompts[0], max_new_tokens=6)
                eng.run_to_completion()
                uids = [eng.submit(p, max_new_tokens=6) for p in prompts[1:]]
                eng.run_to_completion()
                outs[where] = [eng.result(u) for u in [u0] + uids]
                stats[where] = {k: eng.stats[k] for k in keys}
            fused = tk.LAUNCHES["decode_attention_fused"]
            n7 = mk.launches()
            log(f"  {name} f32 pool {kv_quant}: card vs CPU greedy tokens "
                f"{n_same(dict(cuda=outs['cuda'], cpu=outs['cpu']))}/18 "
                f"identical; {stats['cuda']}; card #1 launches {fused}, #7 "
                f"{n7}")
            check(outs["cuda"] == outs["cpu"]
                  and stats["cuda"] == stats["cpu"]
                  and stats["cuda"]["prefix_hits"] == 2,
                  f"{name} pool {kv_quant}: card and CPU differ, or no warm "
                  f"hits: {stats}")
            check((n7 > 0) if name == "TINY_XL" else (fused > 0),
                  f"{name} pool {kv_quant}: its kernel did not run")
            if name == "TINY_XL":
                mlstm += n7
    return mlstm

# ---------------------------------------------------------------------------
# phase 11: durable serving state at phi4-mini width
# ---------------------------------------------------------------------------

# a 1088-token chain is 17 pages of 64: with 25 pages, B's recording
# leaves A its first 8 (512 tokens) and demotes the rest, so a promotion
# that [11b] makes fail restarts A's prefill at the 512-token chunk
# boundary a cold prefill has too (bf16 prefill chunked elsewhere rounds
# differently, and the tokens could then differ from cold)
L2_PAGES = 25
L2_PAGES_A3 = 60           # and a leaf's sorted-key snapshot 32 more
L2_BYTES = 4 << 30


def l2_probe(pc, calls, times):
    """Run a promotion's staging and pool insert and every gather of
    ``pc`` under ``set_sync_debug_mode("error")`` (counted in ``calls``),
    and time each demotion and promotion on the wall clock (a promotion
    without the demotions its page allocation triggers, which are timed
    as demotions) and each insert on the device (CUDA events), into
    ``times``."""
    import torch

    def strict(name, fn):
        def run(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run

    stage = strict("stage", pc._stager.stage)
    pc._stager.stage = stage
    pc.gather_into = strict("gather_into", pc.gather_into)
    insert = strict("insert", pc._insert_page)
    demote, promote = pc._demote, pc._promote
    nested = [0]

    def timed_insert(pid, page):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        insert(pid, page)
        b.record()
        times["insert"].append((a, b))

    def timed_demote(node):
        t0 = time.perf_counter_ns()
        demote(node)
        dt = time.perf_counter_ns() - t0
        nested[0] += dt
        times["demote"].append(dt / 1e6)

    def timed_promote(parent, edge):
        t0, n0 = time.perf_counter_ns(), nested[0]
        child = promote(parent, edge)
        if child is not None:
            times["promote"].append(
                (time.perf_counter_ns() - t0 - (nested[0] - n0)) / 1e6)
        return child

    pc._insert_page = timed_insert
    pc._demote = timed_demote
    pc._promote = timed_promote


def l2_serve(model, cfg, batches, a3, chaos=None, before=None, **knobs):
    """Serve each batch of prompts to the end in turn through
    ``ServeEngine`` (4 slots, max_len 2048, decode_block 4, page 64, 16
    new tokens; ``before(i)`` runs before batch i) -> dict of the
    results, the engine, wall s, #1's launches, the strict-sync call
    counts and the L2 timings."""
    from repro_torch.kernels.decode_attention import kernel as tk
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(model, cfg, slots=4, max_len=2048, a3=a3,
                      decode_block=4, page_size=PREFIX_PAGE, chaos=chaos,
                      **knobs)
    calls, times = {}, {"demote": [], "promote": [], "insert": []}
    if eng._pc is not None and eng._pc.l2 is not None:
        l2_probe(eng._pc, calls, times)
    uids = []
    sync(model.device)
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        if before is not None:
            before(i)
        uids += [eng.submit(p, max_new_tokens=16) for p in batch]
        eng.run_to_completion()
    sync(model.device)
    wall = time.perf_counter() - t0
    outs = [eng.result(u) for u in uids]
    check(all(o is not None and len(o) == 16 for o in outs),
          "an L2 serve's request did not finish with its budget")
    times["insert"] = [a.elapsed_time(b) for a, b in times["insert"]]
    return dict(outs=outs, eng=eng, wall=wall, calls=calls, times=times,
                fused=tk.LAUNCHES["decode_attention_fused"])


def ms_summary(xs):
    if not xs:
        return "none"
    xs = sorted(xs)
    return (f"{len(xs)} x median {xs[len(xs) // 2]:.3f} ms (min "
            f"{xs[0]:.3f}, max {xs[-1]:.3f})")


def phase_l2(model, cfg, dev):
    """[11a] the L2 round trip and [11b] its restore_corrupt site on
    phi4-mini-3.8b (the model [3] built): two 1024-token prefixes A and
    B, each request the prefix and its own 64-token suffix (16 greedy
    new tokens); A's first request alone, then B's first alone (its
    recording demotes A's pages), then three more of A together (A's
    pages promote back, B's demote), then three more of B together (B's
    promote back). Pools: fp and int8 with A^3 off (25 pages), fp with
    A^3 conservative (60 pages: the leaves' 32-page sorted-key snapshots
    demote too). A's and B's requests come in separate batches: two
    chains in flight at once would pin 32 of the 25 pages, and the
    promotions would stop short of the full prefix; with the int8 pool
    the tokens depend on how much of the prefix comes from int8 pages,
    and they are held against the int8 serve whose pool evicts nothing,
    which matches the full prefix -> #1's launches in the A^3-off
    serves."""
    import dataclasses
    import numpy as np
    from repro_torch.config import A3Config
    from repro_torch.serve.chaos import ChaosConfig, ChaosInjector

    rng = np.random.default_rng(11)
    heads = [rng.integers(0, cfg.vocab_size, size=PREFIX_LEN)
             for _ in range(2)]
    reqs = [np.concatenate([heads[i % 2], rng.integers(
        0, cfg.vocab_size, size=SUFFIX_LEN)]) for i in range(8)]
    batches = [reqs[:1], reqs[1:2], reqs[2::2], reqs[3::2]]
    off, cons = A3Config(), A3Config.conservative()
    l2 = dict(l2_bytes=L2_BYTES)
    plan = [("cold off", off, {}),
            ("fp off L2", off, dict(cache_pages=L2_PAGES, **l2)),
            ("int8 off, no eviction", off,
             dict(cache_pages=320, kv_quant="int8")),
            ("int8 off L2", off,
             dict(cache_pages=L2_PAGES, kv_quant="int8", **l2)),
            ("cold conservative", cons, {}),
            ("fp conservative L2", cons,
             dict(cache_pages=L2_PAGES_A3, **l2))]
    runs, fused = {}, 0
    for label, a3, knobs in plan:
        r = l2_serve(model, cfg, batches, a3, **knobs)
        st, eng = r["eng"].stats, r["eng"]
        pc = eng._pc
        line = (f"  {label}: 8 requests {r['wall']:.3f} s wall; "
                f"prefill_tokens {st['prefill_tokens']}, "
                f"prefix_tokens_reused {st['prefix_tokens_reused']}")
        if "off" in label:
            want = cfg.num_layers * st["decode_steps"]
            check(r["fused"] == want > 0, f"{label}: #1 launched "
                  f"{r['fused']} times, expected {want}")
            fused += r["fused"]
        if pc is not None and pc.l2 is not None:
            check(st["l2_spills"] >= 1 and st["l2_hits"] >= 1
                  and st["l2_integrity_drops"] == 0,
                  f"{label}: L2 counters {st}")
            check(r["calls"].get("stage", 0) >= 1
                  and r["calls"].get("insert", 0) == r["calls"]["stage"]
                  and r["calls"].get("gather_into", 0) >= 1,
                  f"{label}: strict-sync calls {r['calls']}")
            sizes = sorted(len(b) for _, b in pc.l2.raw_items())
            t = r["times"]
            line += (f"; l2_spills {st['l2_spills']}, l2_hits "
                     f"{st['l2_hits']}, l2_evictions {st['l2_evictions']}, "
                     f"pages_evicted {st['pages_evicted']}; demotions "
                     f"{ms_summary(t['demote'])} wall ({pc.demote_reads} "
                     f"blocking reads, {pc.demote_read_ns / 1e6:.1f} ms); "
                     f"promotions {ms_summary(t['promote'])} wall; inserts "
                     f"{ms_summary(t['insert'])} device; {len(sizes)} "
                     f"blobs held, {sizes[0]} to {sizes[-1]} bytes (median "
                     f"{sizes[len(sizes) // 2]}); stage / insert / gather "
                     f"under set_sync_debug_mode('error'): {r['calls']}")
        log(line + f" [{CARD}]")
        runs[label] = r
    for got, want in (("fp off L2", "cold off"),
                      ("int8 off L2", "int8 off, no eviction"),
                      ("fp conservative L2", "cold conservative")):
        check(runs[got]["outs"] == runs[want]["outs"],
              f"{got}: tokens differ from {want}")
    lead = runs["fp conservative L2"]["eng"]._pc
    check(any(n.sk_snap is not None for n in lead._nodes),
          "A^3 conservative: no sorted-key snapshot in the trie")
    log("  L2 tokens = cold tokens (fp off, fp conservative) and = the "
        "int8 serve without eviction (int8 off), 8/8 requests each")

    # [11b] restore_corrupt: one blob flipped before its verified
    # restore. The site draws at every stalled trie walk, the cold ones
    # too, so its rate goes from 0 to 1 once A's pages are in L2: the one
    # injection then hits the first promotion
    quiet = ChaosConfig(restore_corrupt=True, rate=0.0, max_injections=1,
                        corrupt_logits=False, fail_gather=False,
                        raise_mid_tick=False)
    ch = ChaosInjector(quiet)

    def arm(i):
        if i == 2:
            ch.config = dataclasses.replace(quiet, rate=1.0)

    r = l2_serve(model, cfg, batches, off, chaos=ch, before=arm,
                 cache_pages=L2_PAGES, **l2)
    st = r["eng"].stats
    kinds = [e[0] for e in ch.events]
    check(kinds == ["restore_corrupt"] and st["l2_integrity_drops"] == 1,
          f"[11b] restore_corrupt: events {ch.events}, drops "
          f"{st['l2_integrity_drops']}")
    check(r["outs"] == runs["cold off"]["outs"],
          "[11b] restore_corrupt: tokens differ from cold")
    fused += r["fused"]
    log(f"  [11b] restore_corrupt at tick {ch.events[0][1]} on a "
        f"{len(ch.events[0][2])}-token key: 1 integrity drop, l2_hits "
        f"{st['l2_hits']}, tokens = cold for 8/8; {r['wall']:.3f} s wall "
        f"[{CARD}]")
    return fused


def ckpt_serve_state(eng):
    phases = [s.phase for s in eng.slots]
    return len(eng._queue), phases.count("prefilling"), \
        phases.count("decoding")


def clock_free(stats):
    return {k: v for k, v in stats.items()
            if not k.startswith("tick_ns") and k not in (
                "host_sync_stalls", "checkpoints", "restores")}


def phase_checkpoint(model, cfg, dev):
    """[11c] phase [3]'s 8 requests (64-token prompts, 4 slots, max_len
    512, decode_block 4; request 0 with 4 new tokens so a slot frees
    early, the others 16; prefill chunk 32 so a prompt takes two ticks),
    A^3 off and conservative: served uninterrupted, then checkpointed
    once at a tick where requests are queued, prefilling and decoding,
    restored into a fresh engine and run to the end -> (#1's launches in
    the A^3-off serves, the chaos-free results by mode)."""
    import tempfile
    import numpy as np
    from pathlib import Path as _P
    from repro_torch.config import A3Config
    from repro_torch.kernels.decode_attention import kernel as tk
    from repro_torch.serve.engine import ServeEngine

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=64) for _ in range(8)]
    budgets = [4] + [16] * 7
    knobs = dict(slots=4, max_len=512, decode_block=4, prefill_chunk=32)
    fused, free = 0, {}
    for mode, a3 in (("off", A3Config()),
                     ("conservative", A3Config.conservative())):
        eng = ServeEngine(model, cfg, a3=a3, **knobs)
        uids = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
        tk.reset_launch_counts()
        eng.run_to_completion()
        sync(dev)
        free[mode] = dict(outs=[eng.result(u) for u in uids],
                          status=[eng.status(u) for u in uids],
                          stats=clock_free(eng.stats), knobs=knobs,
                          prompts=prompts, budgets=budgets)
        if mode == "off":
            fused += tk.LAUNCHES["decode_attention_fused"]
        eng = ServeEngine(model, cfg, a3=a3, **knobs)
        uids = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
        tk.reset_launch_counts()
        while not all(ckpt_serve_state(eng)):
            check(eng.in_flight > 0, "no tick had requests queued, "
                  "prefilling and decoding at once")
            eng.step()
        state, tick = ckpt_serve_state(eng), eng.stats["ticks"]
        with tempfile.TemporaryDirectory() as td:
            path = str(_P(td) / "ckpt")
            sync(dev)
            t0 = time.perf_counter()
            eng.checkpoint(path)
            t_ck = time.perf_counter() - t0
            nbytes = (_P(path) / "arrays.bin").stat().st_size
            del eng
            t0 = time.perf_counter()
            rest = ServeEngine.restore(path, model, cfg, a3=a3)
            sync(dev)
            t_rs = time.perf_counter() - t0
        rest.run_to_completion()
        sync(dev)
        if mode == "off":
            fused += tk.LAUNCHES["decode_attention_fused"]
        check([rest.result(u) for u in uids] == free[mode]["outs"]
              and [rest.status(u) for u in uids] == free[mode]["status"],
              f"[11c] A^3 {mode}: restored tokens or statuses differ from "
              f"the uninterrupted serve")
        check(clock_free(rest.stats) == free[mode]["stats"]
              and rest.stats["restores"] == 1,
              f"[11c] A^3 {mode}: stats differ: {clock_free(rest.stats)} "
              f"against {free[mode]['stats']}")
        log(f"  [11c] A^3 {mode}: checkpoint after tick {tick} with "
            f"{state[0]} queued / {state[1]} prefilling / {state[2]} "
            f"decoding; arrays.bin {nbytes} bytes; checkpoint "
            f"{t_ck:.3f} s, restore {t_rs:.3f} s; restored tokens, "
            f"statuses and clock-free stats = the uninterrupted serve's "
            f"(8/8) [{CARD}]")
    return fused, free


def phase_chaos(model, cfg, dev, free):
    """[11d] chaos on the card: the corrupt site (max_injections 1) on
    [11c]'s serve with A^3 off and conservative (the victim FAILS off a
    POISON harvest, every other request's tokens are the chaos-free
    ones); the raise and delay sites at rate 0.3 (every token the
    chaos-free one); #1 on a served ring with NaN lanes (thresholds
    None and 3.0) against its plain version -> #1's launches in the
    A^3-off serves."""
    import torch
    from repro_torch.config import A3Config
    from repro_torch.kernels.decode_attention import kernel as tk
    from repro_torch.models import decoder
    from repro_torch.serve.chaos import ChaosConfig, ChaosInjector
    from repro_torch.serve.engine import ServeEngine

    fused = 0
    for mode, a3 in (("off", A3Config()),
                     ("conservative", A3Config.conservative())):
        f = free[mode]
        for label, cc in (
                ("corrupt", dict(seed=0, rate=1.0, corrupt_logits=True,
                                 fail_gather=False, raise_mid_tick=False,
                                 max_injections=1)),
                ("raise + delay", dict(seed=3, rate=0.3,
                                       corrupt_logits=False,
                                       fail_gather=False,
                                       raise_mid_tick=True,
                                       delay_mid_tick=True))):
            if label != "corrupt" and mode != "off":
                continue
            ch = ChaosInjector(ChaosConfig(**cc))
            eng = ServeEngine(model, cfg, a3=a3, chaos=ch, **f["knobs"])
            poisoned = set()
            apply = eng._apply_harvest

            def seen(e, h, _apply=apply):
                for si, uid, nb, _ in e.lanes:
                    if (h[si, 1:1 + nb] == decoder.POISON).any():
                        poisoned.add(uid)
                return _apply(e, h)

            eng._apply_harvest = seen
            uids = [eng.submit(p, n) for p, n in zip(f["prompts"],
                                                     f["budgets"])]
            tk.reset_launch_counts()
            eng.run_to_completion()
            sync(dev)
            victims = ch.injected_uids
            for u, want in zip(uids, f["outs"]):
                if u in victims:
                    check(eng.status(u) == "failed" and u in poisoned,
                          f"[11d] {mode}: victim {u} is {eng.status(u)}, "
                          f"POISON seen for {sorted(poisoned)}")
                else:
                    check(eng.result(u) == want, f"[11d] {mode} {label}: "
                          f"request {u}'s tokens differ from chaos-free")
            if label == "corrupt":
                check(len(victims) == 1 and eng.stats["failed"] == 1,
                      f"[11d] {mode}: victims {victims}")
            else:
                aborts = sum(e[0] == "raise" for e in ch.events)
                check(aborts > 0 and eng.stats["chaos_aborted_ticks"]
                      == aborts and eng.stats["chaos_delayed_ticks"] > 0,
                      f"[11d] raise + delay: events {ch.events}, stats "
                      f"{eng.stats}")
            if mode == "off":
                fused += tk.LAUNCHES["decode_attention_fused"]
            kinds = [e[0] for e in ch.events]
            log(f"  [11d] {label} a3={mode}: events "
                + ", ".join(f"{kinds.count(k)} {k}" for k in sorted(
                    set(kinds)))
                + f" (first {ch.events[:2]}); chaos_aborted_ticks "
                f"{eng.stats['chaos_aborted_ticks']}, chaos_delayed_ticks "
                f"{eng.stats['chaos_delayed_ticks']}; victims "
                f"{sorted(victims)} FAILED off a POISON harvest; the other "
                f"{len(uids) - len(victims)} requests' tokens = chaos-free "
                f"[{CARD}]")
            last = eng
    # #1 on the served ring (layer 0 of the last serve) with NaN lanes,
    # thresholds None and 3.0 (A^3's), against its plain version
    kc, vc = last.cache["seg0"]["k"][0], last.cache["seg0"]["v"][0]
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn((kc.shape[0], cfg.num_heads, kc.shape[-1]), generator=g,
                    device=dev).to(kc.dtype)
    mask = torch.zeros((kc.shape[0], cfg.num_heads, kc.shape[2]),
                       dtype=torch.bool, device=dev)
    mask[..., :80] = True
    fused_nan_check(q, kc, vc, mask, "[11d] served ring, layer 0")
    return fused


def phase_durable_tiny(dev):
    """[11d] the tiny float32 TINY, TINY_RG and TINY_XL engines with the
    L2 tier, checkpoints and the crash site (rate 0.3, a checkpoint after
    every tick, a chaos-free restore after each crash): three prompts
    sharing 24 tokens served, the trie spilled to L2, the same prompts
    served again (their pages promote), on the card and on the CPU:
    tokens, clock-free stats and chaos events identical; #1 (#7 for
    TINY_XL) launched on the card -> #7's launches."""
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    from repro_torch.config import A3Config, AttentionKind, BlockKind, \
        ModelConfig
    from repro_torch.kernels.decode_attention import kernel as tk
    from repro_torch.kernels.mlstm_chunk import kernel as mk
    from repro_torch.models import decoder
    from repro_torch.serve.chaos import ChaosConfig, ChaosInjector, \
        EngineCrash
    from repro_torch.serve.engine import ServeEngine

    tiny = ModelConfig("tiny", "dense", num_layers=2, d_model=64,
                       num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                       head_dim=16, dtype="float32")
    configs = {
        "TINY": tiny,
        "TINY_RG": dataclasses.replace(
            tiny, name="tiny-rg", num_layers=3,
            attention_kind=AttentionKind.SLIDING, window_size=24,
            block_pattern=(BlockKind.RGLRU, BlockKind.RGLRU,
                           BlockKind.ATTENTION), act="gelu"),
        "TINY_XL": dataclasses.replace(
            tiny, name="tiny-xl", family="ssm", num_layers=3,
            num_kv_heads=4, d_ff=0,
            block_pattern=(BlockKind.MLSTM, BlockKind.MLSTM,
                           BlockKind.SLSTM)),
    }
    rng = np.random.default_rng(7)
    shared = rng.integers(0, 256, size=24)
    prompts = [np.concatenate([shared, rng.integers(0, 256, size=4 + 3 * i)])
               for i in range(3)]
    knobs = dict(slots=2, max_len=96, a3=A3Config(), prefill_chunk=8,
                 decode_block=4, page_size=8, cache_pages=16,
                 l2_bytes=1 << 22)
    mlstm = 0
    for name, cfg in configs.items():
        cpu = decoder.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
        gpu = copy.deepcopy(cpu).to(dev)
        res = {}
        for where, model in (("cpu", cpu), ("cuda", gpu)):
            tk.reset_launch_counts()
            mk.reset_launch_counts()
            ch = ChaosInjector(ChaosConfig(seed=3, rate=0.3,
                                           corrupt_logits=False,
                                           fail_gather=False,
                                           raise_mid_tick=False,
                                           crash_mid_tick=True))
            with tempfile.TemporaryDirectory() as td:
                path = f"{td}/ckpt"
                eng = ServeEngine(model, cfg, chaos=ch, **knobs)
                uids, crashes = [], 0
                for again in (False, True):
                    if again:
                        eng._pc.spill(10 ** 6)     # the trie goes to L2
                    uids += [eng.submit(p, 6) for p in prompts]
                    eng.checkpoint(path)
                    while eng.in_flight:
                        try:
                            eng.step()
                            eng.checkpoint(path)
                        except EngineCrash:
                            crashes += 1
                            eng = ServeEngine.restore(path, model, cfg,
                                                      a3=knobs["a3"])
            res[where] = dict(
                outs=[eng.result(u) for u in uids], events=list(ch.events),
                stats=clock_free(eng.stats), crashes=crashes,
                restores=eng.stats["restores"])
        fused, n7 = tk.LAUNCHES["decode_attention_fused"], mk.launches()
        st = res["cuda"]["stats"]
        log(f"  [11d] {name} f32 L2 + crash/restore: card vs CPU tokens "
            f"{n_same(dict(cuda=res['cuda']['outs'], cpu=res['cpu']['outs']))}"
            f"/36 identical; crashes {res['cuda']['crashes']} (events "
            f"{res['cuda']['events']}); l2_spills {st['l2_spills']}, "
            f"l2_hits {st['l2_hits']}; card #1 launches {fused}, #7 {n7}")
        check(res["cuda"] == res["cpu"], f"[11d] {name}: card and CPU "
              f"differ: {res['cuda']} / {res['cpu']}")
        check(res["cuda"]["crashes"] >= 1 and st["l2_spills"] > 0
              and st["l2_hits"] > 0, f"[11d] {name}: no crash or no L2 "
              f"round trip: {res['cuda']}")
        check((n7 > 0) if name == "TINY_XL" else (fused > 0),
              f"[11d] {name}: its kernel did not run")
        if name == "TINY_XL":
            mlstm += n7
    return mlstm


# ---------------------------------------------------------------------------
# phase 5: the two-pass path through the ops entry
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 12: the serving telemetry plane at phi4-mini width
# ---------------------------------------------------------------------------

TELEMETRY_EVERY = (1, 8)


def probe_recorder(eng):
    """Keep a copy of every probe block ``eng``'s telemetry takes."""
    rows = []
    orig = eng.tm.on_a3_probe

    def record(probe, _orig=orig):
        rows.append(probe.copy())
        _orig(probe)

    eng.tm.on_a3_probe = record
    return rows


def probed_samples(rows):
    """(captured mass, candidates) per probed lane of every block: the
    block's sums over that lane's advanced steps, over its samples."""
    mass, cand = [], []
    for r in rows:
        live = r[:, 0] > 0
        mass += [float(x) for x in r[live, 2] / r[live, 0]]
        cand += [float(x) for x in r[live, 1] / r[live, 0]]
    return mass, cand


def clock_free_metrics(snap):
    """A metrics snapshot without what the clock decides: the counters
    but the tick times and stalls, every bucket of the count and ratio
    histograms, only the totals of the nanosecond ones."""
    counters = {k: v for k, v in snap["counters"].items()
                if not k.startswith("serve_tick_ns")
                and k != "serve_host_sync_stalls"}
    hists = {n: (h["total"] if n.split("{")[0].endswith("_ns")
                 else (h["bounds"], h["counts"], h["total"]))
             for n, h in snap["histograms"].items()}
    return counters, hists


def trace_by_uid(tm):
    """The trace's event names in order per request uid."""
    out = {}
    for _ts, _ph, name, uid, _track, _dur, _args in tm.tracer.events:
        if uid >= 0:
            out.setdefault(uid, []).append(name)
    return out


def phase_telemetry(model, cfg, dev):
    """[12] phase [3]'s serve (8 requests of 64-token prompts, 16 greedy
    new tokens, 4 slots, max_len 512, decode_block 4) with A^3 off and
    conservative at pipeline_depth 0 and 1: telemetry off, on with
    telemetry_every 1 and 8, and off again (the wall in turns). Holds:
    tokens and ``host_syncs`` = the telemetry-off serve's, stalls 0,
    probe dispatches = ceil(decode_dispatches / every) with A^3 (0
    without), every probed mass in [0, 1], #1 32 x decode_steps in the
    A^3-off serves; a probed tick at depth 0 and 1 under
    ``set_sync_debug_mode("error")``; the trace and metrics files and
    the CLI's ``--stats-json`` read back. Prints the probe's medians, one
    probed decode step against an unprobed one under the profiler, and
    the wall of telemetry on against off -> #1's launches."""
    import json
    import statistics
    import tempfile
    import numpy as np
    import torch
    from pathlib import Path as _P
    from repro_torch.config import A3Config
    from repro_torch.launch import serve as cli
    from repro_torch.models import decoder
    from repro_torch.serve.engine import ServeEngine

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=64) for _ in range(8)]
    knobs = dict(slots=4, max_len=512, decode_block=4)
    fused, kept = 0, {}

    def serve(a3, depth, every):
        tel = {} if every is None else dict(telemetry=True,
                                            telemetry_every=every)
        rows = []

        def watch(eng):
            if eng.tm is not None:
                rows.append(probe_recorder(eng))

        outs, eng, dt, launches = serve_run(
            model, cfg, prompts, a3, 4, 16, on_engine=watch,
            pipeline_depth=depth, **tel)
        return (outs, eng, dt, launches["decode_attention_fused"],
                rows[0] if rows else None)

    for mode, a3 in (("off", A3Config()),
                     ("conservative", A3Config.conservative())):
        base_outs = None
        for depth in (0, 1):
            walls = {}
            base = None
            for every in (None, 1, 8, "again"):
                outs, eng, dt, n1, rows = serve(
                    a3, depth, None if every == "again" else every)
                st = eng.stats
                walls[every] = dt
                label = f"a3={mode} depth {depth}"
                if mode == "off":
                    want = cfg.num_layers * st["decode_steps"]
                    check(n1 == want > 0, f"[12] {label}: #1 launched {n1} "
                          f"times, expected {cfg.num_layers} x "
                          f"decode_steps = {want}")
                    if every in TELEMETRY_EVERY:
                        fused += n1
                if every is None:
                    base = (outs, st["host_syncs"])
                    if base_outs is None:
                        base_outs = outs
                    check(outs == base_outs, f"[12] {label}: tokens "
                          f"differ from depth 0's")
                    continue
                check(outs == base[0], f"[12] {label} every {every}: tokens "
                      f"differ from the telemetry-off serve's")
                check(st["host_syncs"] == base[1] and
                      st["host_sync_stalls"] == 0,
                      f"[12] {label} every {every}: host_syncs "
                      f"{st['host_syncs']} (off: {base[1]}), stalls "
                      f"{st['host_sync_stalls']}")
                if every == "again":
                    continue
                snap = eng.tm.metrics_snapshot()
                nd = st["decode_dispatches"]
                pd = snap["counters"]["serve_a3_probe_dispatches"]
                want = math.ceil(nd / every) if mode != "off" else 0
                check(pd == want, f"[12] {label} every {every}: "
                      f"{pd} probe dispatches, expected {want} of {nd}")
                mass, cand = probed_samples(rows)
                samples = snap["counters"]["serve_a3_probe_samples"]
                if mode != "off":
                    check(samples > 0 and len(mass) > 0 and
                          all(0.0 <= m <= 1.0 for m in mass),
                          f"[12] {label} every {every}: samples {samples}, "
                          f"masses {mass[:8]}")
                    kept[(depth, every)] = (mass, cand, samples, eng)
                log(f"  [12] {label} telemetry every {every}: tokens and "
                    f"host_syncs {st['host_syncs']} = off's, stalls 0; "
                    f"probe dispatches {pd} of {nd} decode dispatches, "
                    f"samples {samples:.0f}")
            log(f"  [12] a3={mode} depth {depth} wall in turns: off "
                f"{walls[None]:.3f} s, every 1 {walls[1]:.3f} s, every 8 "
                f"{walls[8]:.3f} s, off {walls['again']:.3f} s; on / mean "
                f"off: every 1 "
                f"{2 * walls[1] / (walls[None] + walls['again']):.3f}, "
                f"every 8 "
                f"{2 * walls[8] / (walls[None] + walls['again']):.3f} "
                f"[{CARD}]")
    for every in TELEMETRY_EVERY:
        mass, cand, samples, _ = kept[(1, every)]
        log(f"  [12] A^3 conservative every {every}: median captured mass "
            f"{statistics.median(mass):.6f} (min {min(mass):.6f}), median "
            f"candidates per kv head {statistics.median(cand):.1f} over "
            f"{len(mass)} probed lanes x blocks ({samples:.0f} samples) "
            f"[{CARD}]")

    # one probed decode step against an unprobed one, on the ring the
    # conservative depth-1 serve left
    eng = kept[(1, 8)][3]
    a3 = A3Config.conservative()
    tok = torch.arange(4, dtype=torch.int32, device=dev)
    pos = torch.full((4,), 80, dtype=torch.int32, device=dev)
    left = torch.ones((4,), dtype=torch.int32, device=dev)
    prof = {}
    for probe in (False, True):
        def step(probe=probe):
            decoder.decode_block(model, cfg, eng.cache, tok, pos, left,
                                 steps=1, a3=a3, probe=probe)

        ms = cuda_ms(step, [()], 5)
        dev_ms, n_kernels, _, _ = profile_steps(step, steps=2)
        check(dev_ms is not None, "[12] the profiler saw no device activity")
        prof[probe] = (ms, dev_ms, n_kernels)
    (m0, d0, k0), (m1, d1, k1) = prof[False], prof[True]
    log(f"  [12] one A^3 conservative decode step (B=4, position 80, 32 "
        f"layers): unprobed {m0:.3f} ms by events, {d0:.3f} ms device over "
        f"{k0:.0f} kernels; probed {m1:.3f} ms, {d1:.3f} ms device over "
        f"{k1:.0f} kernels; the probe adds {d1 - d0:.3f} ms device "
        f"({d1 / d0:.2f}x) and {k1 - k0:.0f} kernels [{CARD}]")

    # a probed dispatch and the harvest of a probed block with every
    # synchronizing CUDA call an error, at depth 0 and 1
    for depth in (0, 1):
        eng = ServeEngine(model, cfg, a3=a3, pipeline_depth=depth,
                          telemetry=True, telemetry_every=1, **knobs)
        for p in prompts[:4]:
            eng.submit(p, max_new_tokens=16)
        eng.step()
        eng.step()
        check(all(s.decoding for s in eng.slots),
              f"[12] depth {depth}: no steady decode after two ticks")
        before = dict(eng.stats)
        probed = eng.tm.c_probe_dispatches.value
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(eng.stats["decode_dispatches"] == before["decode_dispatches"]
              + 1 and eng.tm.c_probe_dispatches.value > probed and
              eng.stats["host_syncs"] == before["host_syncs"] + 1,
              f"[12] depth {depth}: the checked tick was not one probed "
              f"dispatch and one harvest of a probed block")
        eng.run_to_completion()
        log(f"  [12] depth {depth}: a probed dispatch and the harvest of a "
            f"probed block under set_sync_debug_mode('error'): no "
            f"synchronizing call")

    # the files: trace, metrics, and the CLI's --stats-json
    _, _, _, eng = kept[(1, 8)]
    with tempfile.TemporaryDirectory() as td:
        tpath, mpath, spath = (str(_P(td) / f) for f in
                               ("trace.json", "metrics.json", "stats.json"))
        eng.tm.write_trace(tpath)
        trace = json.loads(_P(tpath).read_text())
        spans = {}
        for e in trace["traceEvents"]:
            if e["name"] == "decode_block":
                spans.setdefault(e["tid"], []).append(e["ts"])
        check(trace["otherData"]["schema"] == "a3-serve-trace/v1" and spans
              and all(ts == sorted(ts) for ts in spans.values()),
              "[12] the trace's decode_block spans are not monotone per slot")
        eng.tm.write_metrics(mpath)
        check(json.loads(_P(mpath).read_text()) == json.loads(json.dumps(
            eng.tm.metrics_snapshot())), "[12] the metrics file differs")
        saved = decoder.init_params
        decoder.init_params = lambda *a, **k: model
        try:
            cli.main(["--arch", cfg.name, "--requests", "8", "--prompt-len",
                      "64", "--max-new", "16", "--decode-block", "4",
                      "--pipeline-depth", "1", "--a3", "conservative",
                      "--telemetry", "--telemetry-every", "8",
                      "--stats-json", spath, "--device", dev.type])
        finally:
            decoder.init_params = saved
        stats = json.loads(_P(spath).read_text())
        check(stats["schema"] == "a3-serve-stats/v2"
              and stats["config"]["serve"]["telemetry"] is True
              and clock_free(stats["stats"]) == clock_free(eng.stats)
              and clock_free_metrics(stats["metrics"])
              == clock_free_metrics(eng.tm.metrics_snapshot()),
              "[12] the CLI's --stats-json differs from the engine's serve")
        log(f"  [12] trace ({len(trace['traceEvents'])} events, decode_block "
            f"spans monotone on {len(spans)} slots), metrics file and the "
            f"CLI's --stats-json read back; the CLI's clock-free stats and "
            f"metrics = the engine's")
    return fused


def phase_telemetry_tiny(dev):
    """[12b] the tiny float32 TINY (A^3 conservative: probed), TINY_RG
    and TINY_XL engines with telemetry every 2 on the card and on the
    CPU: tokens, clock-free metrics and each request's trace events
    identical, probe rows within 2e-5; #1 (TINY_RG) and #7 (TINY_XL)
    launched on the card -> #7's launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.config import A3Config, AttentionKind, BlockKind, \
        ModelConfig
    from repro_torch.kernels.decode_attention import kernel as tk
    from repro_torch.kernels.mlstm_chunk import kernel as mk
    from repro_torch.models import decoder
    from repro_torch.serve.engine import ServeEngine

    tiny = ModelConfig("tiny", "dense", num_layers=2, d_model=64,
                       num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                       head_dim=16, dtype="float32")
    configs = {
        "TINY": (tiny, A3Config.conservative()),
        "TINY_RG": (dataclasses.replace(
            tiny, name="tiny-rg", num_layers=3,
            attention_kind=AttentionKind.SLIDING, window_size=24,
            block_pattern=(BlockKind.RGLRU, BlockKind.RGLRU,
                           BlockKind.ATTENTION), act="gelu"), A3Config()),
        "TINY_XL": (dataclasses.replace(
            tiny, name="tiny-xl", family="ssm", num_layers=3,
            num_kv_heads=4, d_ff=0,
            block_pattern=(BlockKind.MLSTM, BlockKind.MLSTM,
                           BlockKind.SLSTM)), A3Config()),
    }
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, size=n) for n in (5, 12, 23, 31, 9)]
    mlstm = 0
    for name, (cfg, a3) in configs.items():
        cpu = decoder.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
        gpu = copy.deepcopy(cpu).to(dev)
        res = {}
        for where, model in (("cpu", cpu), ("cuda", gpu)):
            eng = ServeEngine(model, cfg, slots=4, max_len=96, a3=a3,
                              prefill_chunk=8, resort_every=2,
                              decode_block=4, telemetry=True,
                              telemetry_every=2)
            rows = probe_recorder(eng)
            uids = [eng.submit(p, max_new_tokens=6) for p in prompts]
            tk.reset_launch_counts()
            mk.reset_launch_counts()
            eng.run_to_completion()
            res[where] = dict(outs=[eng.result(u) for u in uids],
                              metrics=clock_free_metrics(
                                  eng.tm.metrics_snapshot()),
                              trace=trace_by_uid(eng.tm), rows=rows)
        n1, n7 = tk.LAUNCHES["decode_attention_fused"], mk.launches()
        mlstm += n7
        c, h = res["cuda"], res["cpu"]
        err = max((float(np.abs(a - b).max()) for a, b in
                   zip(c["rows"], h["rows"])), default=0.0)
        check(c["outs"] == h["outs"] and c["metrics"] == h["metrics"]
              and c["trace"] == h["trace"]
              and len(c["rows"]) == len(h["rows"])
              and all(np.allclose(a, b, rtol=2e-5, atol=2e-5)
                      for a, b in zip(c["rows"], h["rows"])),
              f"[12b] {name}: card and CPU differ (probe rows max err "
              f"{err})")
        check((len(c["rows"]) > 0) == (name == "TINY")
              and (n1 > 0) == (name == "TINY_RG")
              and (n7 > 0) == (name == "TINY_XL"),
              f"[12b] {name}: {len(c['rows'])} probe blocks, #1 {n1}, "
              f"#7 {n7}")
        log(f"  [12b] {name} f32 a3={a3.mode.value} telemetry every 2: card "
            f"vs CPU tokens {n_same(dict(cuda=c['outs'], cpu=h['outs']))}"
            f"/30, clock-free metrics and trace identical; {len(c['rows'])} "
            f"probe blocks within {err:.3g}; card #1 launches {n1}, #7 {n7}")
    return mlstm


def phase_two_pass(ring, dev):
    import torch
    from repro_torch.config import A3Config
    from repro_torch.core.candidate_selection import sort_key_columns
    from repro_torch.kernels.decode_attention import kernel as tk
    from repro_torch.kernels.decode_attention.ops import a3_decode_attention

    k = ring["k"][0].contiguous()             # layer 0, [4, 8, 512, 128]
    v = ring["v"][0].contiguous()
    b, hkv, s, d = k.shape
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((b, 3 * hkv, d), generator=g, device=dev).to(k.dtype)
    valid = torch.arange(s, device=dev)[None, :] < torch.tensor(
        [[80], [79], [64], [80]], device=dev)
    a3 = A3Config.conservative()
    sk = sort_key_columns(k)
    sync(dev)
    tk.reset_launch_counts()
    out = a3_decode_attention(q, k, v, valid, a3, sorted_keys=sk,
                              exact_two_pass=True)
    sync(dev)
    launches = dict(tk.LAUNCHES)
    check(dev.type != "cuda" or (launches["decode_attention_rowmax"] == 1
                                 and launches["decode_attention_attend"] == 1),
          f"two-pass path launches {launches}")
    want = a3_decode_attention(q.cpu(), k.cpu(), v.cpu(), valid.cpu(), a3,
                               sorted_keys=sort_key_columns(k.cpu()),
                               exact_two_pass=True)
    e, ok = max_err(out.cpu(), want)
    check(bool(torch.isfinite(out).all()) and ok,
          f"two-pass path on the card vs CPU: max_abs_err {e}")
    log(f"  a3_decode_attention(exact_two_pass=True) on the card vs CPU: "
        f"max_abs_err {e:.3g}; launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 6: TINY f32, card vs CPU
# ---------------------------------------------------------------------------

def card_vs_cpu_tokens(cfg, dev, a3, reset_counts, **knobs):
    """Tokens of the port's engine on a tiny float32 ``cfg`` (random
    weights from seed 0; 4 slots, chunk 8, decode_block 4, resort_every
    2, five prompts of 5-31 tokens, 6 new tokens each; greedy unless
    ``knobs`` say otherwise) on the CPU and on the card -> {"cpu": [...],
    "cuda": [...]}. The kernel counts are reset just before each run, so
    after the call they hold the card run's launches."""
    import numpy as np
    import torch
    from repro_torch.models import decoder
    from repro_torch.serve.engine import ServeEngine

    cpu = decoder.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = copy.deepcopy(cpu).to(dev)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, size=n) for n in (5, 12, 23, 31, 9)]
    outs = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        eng = ServeEngine(model, cfg, slots=4, max_len=96, a3=a3,
                          prefill_chunk=8, resort_every=2, decode_block=4,
                          **knobs)
        uids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        reset_counts()
        eng.run_to_completion()
        outs[name] = [eng.result(u) for u in uids]
    return outs


def n_same(outs):
    return sum(a == b for o, r in zip(outs["cuda"], outs["cpu"])
               for a, b in zip(o, r))


def phase_tiny(dev):
    from repro_torch.config import A3Config, ModelConfig
    from repro_torch.kernels.decode_attention import kernel as tk

    tiny = ModelConfig("tiny", "dense", num_layers=2, d_model=64,
                       num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                       head_dim=16, dtype="float32")
    for mode, a3 in (("off", A3Config()),
                     ("conservative", A3Config.conservative())):
        outs = card_vs_cpu_tokens(tiny, dev, a3, tk.reset_launch_counts)
        log(f"  TINY f32 a3={mode}: card vs CPU greedy tokens "
            f"{n_same(outs)}/30 identical; card fused launches "
            f"{tk.LAUNCHES['decode_attention_fused']}")
        if mode == "off":
            check(outs["cuda"] == outs["cpu"],
                  "TINY f32 tokens differ between the card and the CPU")
    # [6b] tempered draws: the threefry keys and bits are int64
    # elementwise ops, so the card and the CPU draw the same tokens
    outs = card_vs_cpu_tokens(tiny, dev, A3Config(), tk.reset_launch_counts,
                              temperature=0.8, sample_seed=0,
                              pipeline_depth=1)
    log(f"  [6b] TINY f32 T=0.8 depth 1: card vs CPU sampled tokens "
        f"{n_same(outs)}/30 identical")
    check(outs["cuda"] == outs["cpu"],
          "TINY f32 sampled tokens differ between the card and the CPU")


# ---------------------------------------------------------------------------
# phase 7: A^3 prefill attention at phi4-mini width
# ---------------------------------------------------------------------------

PREFILL = dict(b=1, hq=24, hkv=8, s=2048, d=128)   # phi4-mini, one prompt
N_PREFILL_SETS = 4         # 4 x 34 MB of q/k/v/out > 50 MB of L2
T_CONS = 3.0               # threshold of the timed attend (~5%, conservative)


def prefill_inputs(seed, dev, sq=None):
    """bf16 q [1,24,Sq,128], k/v [1,8,2048,128] from a seed."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    b, hq, hkv, s, d = (PREFILL[x] for x in ("b", "hq", "hkv", "s", "d"))
    q = torch.randn((b, hq, sq or s, d), generator=g, device=dev)
    k = torch.randn((b, hkv, s, d), generator=g, device=dev)
    v = torch.randn((b, hkv, s, d), generator=g, device=dev)
    return q.bfloat16(), k.bfloat16(), v.bfloat16()


def random_map(seed, dev, density=0.5, shape=PREFILL):
    """A per-query-head block map of the given density, diagonal kept,
    unioned per kv head as the kernels take it."""
    import torch
    from repro_torch.kernels.a3_attention import kernel as ak
    b, hq, hkv, s = (shape[x] for x in ("b", "hq", "hkv", "s"))
    nq = s // 128
    g = torch.Generator(device=dev).manual_seed(seed)
    bm = torch.rand((b, hq, nq, nq), generator=g, device=dev) < density
    bm |= torch.eye(nq, dtype=torch.bool, device=dev)
    return ak.union_block_map_gqa(*ak.build_block_map(bm), hq // hkv, nq)


def flash_pairs(sq, sk, causal=True, window=None):
    """Query-key pairs one head's mask admits (prefill offset sk - sq)."""
    import numpy as np
    pos = np.arange(sq) + (sk - sq)
    hi = np.minimum(sk, pos + 1) if causal else np.full(sq, sk)
    lo = np.maximum(0, pos - window + 1) if window else np.zeros(sq, int)
    return int(np.maximum(hi - lo, 0).sum())


def sparse_need(q, k, idx, cnt, rm, thr):
    """(admitted pairs, kept pairs, K rows, V rows) the block-sparse pair
    needs on these inputs: pairs inside live blocks under the causal
    mask, kept = admitted and s >= rowmax - thr; K rows of blocks live
    for some q block, V rows with some kept weight."""
    import torch
    from repro_torch.kernels.a3_attention import kernel as ak
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g, nk = hq // hkv, sk // 128
    live = ak.block_map_to_mask(idx, cnt, nk)                # [B,Hkv,nq,nk]
    elem = live.repeat_interleave(128, 2).repeat_interleave(128, 3)
    elem &= torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
    elem = elem[:, :, None]                                  # [B,Hkv,1,Sq,Sk]
    admitted = int(elem.sum()) * g
    krows = int(live.any(2).sum()) * 128
    sc = torch.einsum("bhgqd,bhkd->bhgqk",
                      q.float().reshape(b, hkv, g, sq, d), k.float())
    sc = sc * d ** -0.5
    keep = elem & (sc >= rm[..., None] - thr)
    return admitted, int(keep.sum()), krows, int(keep.any(3).any(2).sum())


def flash_bound(shape):
    """Bound of #4 causal at ``shape``: q, k, v and the output moved once,
    4*D operations per admitted pair."""
    b, hq, hkv, s, d = (shape[x] for x in ("b", "hq", "hkv", "s", "d"))
    nbytes = (2 * b * hq * s * d + 2 * b * hkv * s * d) * 2
    return bound(nbytes, 4 * d * b * hq * flash_pairs(s, s))


def prefill_bounds(sets, maps, rms, shape):
    """(sparse_need per input set, bounds of #5 and #6 at t=T_CONS) over
    bf16 q/k/v ``sets``, their block ``maps`` and #5's row maxima: q, the
    maps, the K rows of live blocks (and for #6 the V rows with a kept
    weight), the row maxima and #6's output moved once; 2*D operations
    per admitted pair, + 2*Dv per kept pair in #6."""
    b, hq, s, d = (shape[x] for x in ("b", "hq", "s", "d"))
    need = [sparse_need(x[0], x[1], *m, rm, T_CONS)
            for x, m, rm in zip(sets, maps, rms)]
    map_bytes = maps[0][0].numel() * 4 + maps[0][1].numel() * 4
    q_bytes = o_bytes = b * hq * s * d * 2
    rm_bytes = b * hq * s * 4
    return need, {
        "rowmax": mean_bound([(q_bytes + n[2] * d * 2 + map_bytes + rm_bytes,
                               2 * d * n[0]) for n in need]),
        "attend": mean_bound([(q_bytes + n[2] * d * 2 + n[3] * d * 2
                               + map_bytes + rm_bytes + o_bytes,
                               2 * d * n[0] + 2 * d * n[1]) for n in need]),
    }


def phase_prefill_kernels(dev):
    """[7](a): kernels #4-#6 vs their plain versions at phi4-mini width,
    then their times, bounds and the library yardstick."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.a3_attention import kernel as ak
    from repro_torch.kernels.flash_attention import kernel as fk

    errs = {"flash": 0.0, "rowmax": 0.0, "attend": 0.0}
    q, k, v = prefill_inputs(100, dev)
    q512 = prefill_inputs(101, dev, sq=512)[0]
    fk.reset_launch_counts()
    for name, args, kw in (("causal", (q, k, v), {}),
                           ("window 512", (q, k, v), {"window": 512}),
                           ("Sq 512 vs Sk 2048", (q512, k, v), {})):
        e, ok = max_err(fk.flash_attention(*args, **kw),
                        fk.flash_attention_plain(*args, **kw))
        check(ok, f"flash kernel disagrees with its plain version ({name})"
                  f": {e}")
        errs["flash"] = max(errs["flash"], e)
        log(f"  flash ({name}) vs plain: max_abs_err {e:.3g}")
    check(fk.LAUNCHES == {"flash_attention_wgmma": 3,
                          "flash_attention_simt": 0},
          f"bf16 flash calls at phi4 width took {fk.LAUNCHES}, expected "
          f"the tensor-core route three times")
    log(f"  flash routes at phi4 width, bf16: {fk.LAUNCHES}")
    idx, cnt = random_map(100, dev)
    for dtype, route in (("bf16", "wgmma"), ("f32", "simt")):
        qq, kk, vv = (q, k, v) if dtype == "bf16" else \
            (q.float(), k.float(), v.float())
        ak.reset_launch_counts()
        rm = ak.sparse_rowmax(qq, kk, idx, cnt)
        e, ok = max_err(rm, ak.sparse_rowmax_plain(qq, kk, idx, cnt))
        check(ok, f"sparse row-max kernel disagrees ({dtype}): {e}")
        errs["rowmax"] = max(errs["rowmax"], e)
        for thr in (None, T_CONS):
            out = ak.sparse_attend(qq, kk, vv, idx, cnt, rm, threshold=thr)
            e, ok = max_err(out, ak.sparse_attend_plain(
                qq, kk, vv, idx, cnt, rm, threshold=thr))
            check(ok, f"sparse attend kernel disagrees ({dtype}, "
                      f"thr={thr}): {e}")
            errs["attend"] = max(errs["attend"], e)
        want = {name: 0 for name in ak.LAUNCHES}
        want.update({f"a3_sparse_rowmax_{route}": 1,
                     f"a3_sparse_attend_{route}": 2})
        check(ak.LAUNCHES == want,
              f"{dtype} sparse calls at phi4 width took {ak.LAUNCHES}, "
              f"expected {want}")
        log(f"  sparse routes at phi4 width, {dtype}: {ak.LAUNCHES}")
    log(f"  sparse (density 0.5, diagonal kept) vs plain: max_abs_err "
        f"rowmax {errs['rowmax']:.3g}, attend {errs['attend']:.3g} "
        f"(bf16 and f32, thresholds None and {T_CONS}; tolerance atol "
        f"{TOL['atol']} + rtol {TOL['rtol']})")
    threshold_zero_check(q, k, v, idx, cnt)
    prefill_nan_check(q, k, v, idx, cnt)
    sync(dev)

    # timed: each over 4 input sets (> L2), as the path calls it
    sets = [prefill_inputs(200 + i, dev) for i in range(N_PREFILL_SETS)]
    maps = [random_map(200 + i, dev) for i in range(N_PREFILL_SETS)]
    b, hq, s = (PREFILL[x] for x in ("b", "hq", "s"))
    res = {}
    def sdpa(*x):
        return F.scaled_dot_product_attention(*x, is_causal=True,
                                              enable_gqa=True)

    res["flash"] = dict(
        ms=cuda_ms(lambda *x: fk.flash_attention(*x), sets, 50),
        plain_ms=cuda_ms(lambda *x: fk.flash_attention_plain(*x), sets, 4),
        library_ms=cuda_ms(sdpa, sets, 50),
        bound=flash_bound(PREFILL),
        device_ms=device_ms(lambda *x: fk.flash_attention(*x), sets, 50,
                            True),
        library_device_ms=device_ms(sdpa, sets, 50))
    rsets = [(x[0], x[1], *m) for x, m in zip(sets, maps)]
    rms = [ak.sparse_rowmax(*a) for a in rsets]
    need, bounds = prefill_bounds(sets, maps, rms, PREFILL)
    res["rowmax"] = dict(
        ms=cuda_ms(lambda *x: ak.sparse_rowmax(*x), rsets, 50),
        plain_ms=cuda_ms(lambda *x: ak.sparse_rowmax_plain(*x), rsets, 3),
        library_ms=None, bound=bounds["rowmax"],
        device_ms=device_ms(lambda *x: ak.sparse_rowmax(*x), rsets, 50,
                            True))
    asets = [(x[0], x[1], x[2], *m, rm) for x, m, rm in zip(sets, maps, rms)]
    res["attend"] = dict(
        ms=cuda_ms(lambda *x: ak.sparse_attend(*x, threshold=T_CONS), asets,
                   50),
        plain_ms=cuda_ms(lambda *x: ak.sparse_attend_plain(
            *x, threshold=T_CONS), asets, 3),
        library_ms=None, bound=bounds["attend"],
        device_ms=device_ms(lambda *x: ak.sparse_attend(*x, threshold=T_CONS),
                            asets, 50, True))
    n0 = need[0]
    log(f"  timed map: {n0[0] / (b * hq * flash_pairs(s, s)):.3f} of the "
        f"causal pairs admitted, {n0[1] / max(n0[0], 1):.3f} of those kept "
        f"at t={T_CONS}")
    for name, r in res.items():
        lib = ("not applicable" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms (SDPA causal GQA)")
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}"
            f" ms, library {lib}, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]}) [{CARD}]")
    r = res["flash"]
    log(f"  flash by device time per launch (torch.profiler): kernel "
        f"{fmt_ms(r['device_ms'])}, SDPA {fmt_ms(r['library_device_ms'])}; "
        f"by the event loop: kernel {r['ms']:.4f} ms, SDPA "
        f"{r['library_ms']:.4f} ms [{CARD}]")
    a, m = res["attend"], res["rowmax"]
    log(f"  sparse attend (#6, t={T_CONS}) beside flash (#4) on the same "
        f"q/k/v: #6 {a['ms']:.4f} ms by events, {fmt_ms(a['device_ms'])} "
        f"device; #4 {r['ms']:.4f} ms by events, {fmt_ms(r['device_ms'])} "
        f"device [{CARD}]")
    pair = None if None in (m["device_ms"], a["device_ms"]) \
        else m["device_ms"] + a["device_ms"]
    log(f"  sparse row max (#5): {m['ms']:.4f} ms by events, "
        f"{fmt_ms(m['device_ms'])} device; #5 + #6 {fmt_ms(pair)} device "
        f"[{CARD}]")
    return errs, res


def prefill_nan_check(q, k, v, idx, cnt):
    """#4, #5 and #6 against their plain versions on a NaN key (key 200
    of every kv head, V finite), bf16 (the tensor-core routes) and
    float32 (the CUDA-core routes): #5's row max is NaN for every query
    that admits the key, as ``jnp.maximum`` makes it in the Pallas
    kernel, so #6 keeps nothing of those rows under a threshold (zero
    rows) and NaN without one; #4's running max takes the NaN score too.
    NaN and zero rows must be the plain versions', the rest within the
    bf16 tolerance."""
    import torch
    from repro_torch.kernels.a3_attention import kernel as ak
    from repro_torch.kernels.flash_attention import kernel as fk
    k = k.clone()
    k[:, :, 200] = float("nan")
    worst = 0.0
    for dtype in ("bf16", "f32"):
        qq, kk, vv = (q, k, v) if dtype == "bf16" else \
            (q.float(), k.float(), v.float())
        for window in (None, 512):
            worst = max(worst, nan_rows_check(
                fk.flash_attention(qq, kk, vv, window=window),
                fk.flash_attention_plain(qq, kk, vv, window=window),
                f"#4 on a NaN key ({dtype}, window={window})"))
        rm = ak.sparse_rowmax(qq, kk, idx, cnt)
        want_rm = ak.sparse_rowmax_plain(qq, kk, idx, cnt)
        worst = max(worst, nan_rows_check(rm[..., None], want_rm[..., None],
                                          f"#5 on a NaN key ({dtype})"))
        check(bool(torch.isnan(want_rm).any()),
              "no query admitted the NaN key")
        for thr in (None, T_CONS):
            worst = max(worst, nan_rows_check(
                ak.sparse_attend(qq, kk, vv, idx, cnt, rm, threshold=thr),
                ak.sparse_attend_plain(qq, kk, vv, idx, cnt, want_rm,
                                       threshold=thr),
                f"#6 on a NaN key ({dtype}, thr={thr})"))
    log(f"  #4-#6 on a NaN key (bf16 and f32): the NaN rows (#4, #5, #6 "
        f"without threshold) and zero rows (#6 at {T_CONS}) are the plain "
        f"versions', the other rows within {worst:.3g}")


def threshold_zero_check(q, k, v, idx, cnt):
    """At threshold 0 the attend pass keeps exactly the entries equal to
    the row-max pass's maximum, so every row that admits an entry must
    return a non-zero row (V at its argmax), in bf16 (the tensor-core
    pair) and float32 (the CUDA-core pair)."""
    from repro_torch.kernels.a3_attention import kernel as ak
    b, hq, sq, _ = q.shape
    admits = (ak.sparse_rowmax_plain(q, k, idx, cnt) > ak.NEG_INF)
    admits = admits.reshape(b, hq, sq)
    for dtype in ("bf16", "f32"):
        qq, kk, vv = (q, k, v) if dtype == "bf16" else \
            (q.float(), k.float(), v.float())
        out = ak.a3_sparse_attention(qq, kk, vv, idx, cnt, threshold=0.0)
        lost = int(((out == 0).all(-1) & admits).sum())
        check(lost == 0, f"threshold 0 ({dtype}): {lost} of "
                         f"{int(admits.sum())} admitting rows came back 0")
        log(f"  threshold 0 ({dtype}): all {int(admits.sum())} admitting "
            f"rows keep their maximum (non-zero output)")


def clustered_qkv(seed, dev, n_clusters=8, spread=0.15):
    """The recipe of benchmarks/bench_kernels.py::_clustered, per kv head:
    keys around random centres, each query near its position's centre
    (noise 0.3), both scaled by 0.5; v random."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    b, hq, hkv, s, d = (PREFILL[x] for x in ("b", "hq", "hkv", "s", "d"))
    cents = torch.randn((b, hkv, n_clusters, d), generator=g, device=dev)
    assign = torch.randint(0, n_clusters, (b, hkv, s), generator=g,
                           device=dev)
    at = torch.gather(cents, 2, assign[..., None].expand(b, hkv, s, d))
    k = at + spread * torch.randn((b, hkv, s, d), generator=g, device=dev)
    q = at.repeat_interleave(hq // hkv, 1) + 0.3 * torch.randn(
        (b, hq, s, d), generator=g, device=dev)
    v = torch.randn((b, hkv, s, d), generator=g, device=dev)
    return (q * 0.5).bfloat16(), (k * 0.5).bfloat16(), v.bfloat16()


def layer0_qkv(model, cfg, dev):
    """Layer 0's q/k/v on a 2048-token random prompt: the model's embed,
    the layer's rmsnorm and attention_qkv at positions 0..2047."""
    import torch
    from repro_torch.models import decoder
    from repro_torch.models.common import attention_qkv, rmsnorm
    s = PREFILL["s"]
    g = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (1, s), generator=g,
                           device=dev)
    blk = model.segs[0].layers[0]
    hn = rmsnorm(blk.ln1, decoder.embed_tokens(model, cfg, tokens),
                 cfg.norm_eps)
    pos = torch.arange(s, device=dev)[None]
    q, k, v = attention_qkv(blk.attn, hn, pos, cfg.num_heads,
                            cfg.num_kv_heads, cfg.resolved_head_dim,
                            cfg.rope_theta)
    return q.contiguous(), k.contiguous(), v.contiguous()


def phase_prefill_path(model, cfg, dev):
    """[7](b): the public a3_attention in modes OFF, conservative and
    aggressive on layer-0 activations and on clustered keys; each timed
    call follows one untimed warm-up call, and the launch counts are read
    around the timed call."""
    import torch
    from repro_torch.config import A3Config
    from repro_torch.kernels.a3_attention import kernel as ak
    from repro_torch.kernels.a3_attention import ops as aops
    from repro_torch.kernels.flash_attention import kernel as fk

    launches = {"flash_attention_wgmma": 0, "flash_attention_simt": 0,
                "a3_sparse_rowmax_wgmma": 0, "a3_sparse_rowmax_simt": 0,
                "a3_sparse_attend_wgmma": 0, "a3_sparse_attend_simt": 0}
    nq = PREFILL["s"] // 128
    tri = PREFILL["b"] * PREFILL["hkv"] * nq * (nq + 1) // 2
    tril = torch.ones(nq, nq, dtype=torch.bool, device=dev).tril()
    for data, (q, k, v) in (("phi4 layer 0", layer0_qkv(model, cfg, dev)),
                            ("clustered", clustered_qkv(3, dev))):
        off = None
        for mode, a3 in (("off", A3Config()),
                         ("conservative", A3Config.conservative()),
                         ("aggressive", A3Config.aggressive())):
            aops.a3_attention(q, k, v, a3, causal=True)    # warm-up
            sync(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            fk.reset_launch_counts()
            ak.reset_launch_counts()
            t0 = time.perf_counter()
            out = aops.a3_attention(q, k, v, a3, causal=True)
            sync(dev)
            op_ms = (time.perf_counter() - t0) * 1e3
            got = {**fk.LAUNCHES, **ak.LAUNCHES}
            peak = torch.cuda.max_memory_allocated(dev)
            check(out.shape == q.shape and bool(torch.isfinite(out).all()),
                  f"a3_attention ({data}, {mode}) gave a non-finite or "
                  f"misshapen output")
            want = {"flash_attention_wgmma": int(mode == "off"),
                    "flash_attention_simt": 0,
                    "a3_sparse_rowmax_wgmma": int(mode != "off"),
                    "a3_sparse_rowmax_simt": 0,
                    "a3_sparse_attend_wgmma": int(mode != "off"),
                    "a3_sparse_attend_simt": 0}
            check(got == want or dev.type != "cuda",
                  f"a3_attention ({data}, {mode}) launched "
                               f"{got}, expected {want}")
            for name in launches:
                launches[name] += got[name]
            line = (f"  a3_attention {data} a3={mode}: op {op_ms:.1f} ms, "
                    f"peak {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f}"
                    f" GiB above the {base / 2**30:.2f} GiB held)")
            if mode == "off":
                off = out.float()
                kms = cuda_ms(lambda: fk.flash_attention(q, k, v), [()], 5)
                line += f", kernel {kms:.3f} ms"
            else:
                t0 = time.perf_counter()
                idx, cnt = aops.candidate_block_map_for_heads(q, k, a3)
                sync(dev)
                sel_ms = (time.perf_counter() - t0) * 1e3
                kms = cuda_ms(lambda: ak.a3_sparse_attention(
                    q, k, v, idx, cnt, threshold=a3.threshold_nats), [()], 5)
                live = ak.block_map_to_mask(idx, cnt, nq) & tril
                rel = float((out.float() - off).norm() / off.norm())
                line += (f", selection {sel_ms:.1f} ms, kernels (#5+#6) "
                         f"{kms:.3f} ms; live blocks {int(live.sum())}/{tri}"
                         f" = {int(live.sum()) / tri:.3f} of the causal "
                         f"blocks; rel err vs off {rel:.4f}")
            log(line + f" [{CARD}]")
    return launches


def phase_prefill_cpu(dev):
    """[7](c): a3_attention on the card vs the same port on the CPU at a
    small float32 shape, all three modes. q and k take values in
    {-1, 0, 1} and D=64 makes the scale 1/8, so every score is exact in
    float32 in any summation order: block maps and kept sets must be
    identical, and outputs agree to the order of exp-sums and P.V
    (tolerance 1e-4)."""
    import torch
    from repro_torch.config import A3Config
    from repro_torch.kernels.a3_attention import kernel as ak
    from repro_torch.kernels.a3_attention import ops as aops
    from repro_torch.kernels.flash_attention import kernel as fk
    g = torch.Generator().manual_seed(11)
    q = torch.randint(-1, 2, (1, 6, 512, 64), generator=g).float()
    k = torch.randint(-1, 2, (1, 2, 512, 64), generator=g).float()
    v = torch.randn((1, 2, 512, 64), generator=g)
    for mode, a3 in (("off", A3Config()),
                     ("conservative", A3Config.conservative()),
                     ("aggressive", A3Config.aggressive())):
        want = aops.a3_attention(q, k, v, a3)
        fk.reset_launch_counts()
        ak.reset_launch_counts()
        got = aops.a3_attention(q.to(dev), k.to(dev), v.to(dev), a3).cpu()
        routes = {**fk.LAUNCHES, **ak.LAUNCHES}
        check(routes == {"flash_attention_wgmma": 0,
                         "flash_attention_simt": int(mode == "off"),
                         "a3_sparse_rowmax_wgmma": 0,
                         "a3_sparse_rowmax_simt": int(mode != "off"),
                         "a3_sparse_attend_wgmma": 0,
                         "a3_sparse_attend_simt": int(mode != "off")},
              f"f32 a3_attention ({mode}) took {routes}, expected the "
              f"CUDA-core routes")
        same = True
        if mode != "off":
            for a, b_ in zip(aops.candidate_block_map_for_heads(
                    q.to(dev), k.to(dev), a3),
                    aops.candidate_block_map_for_heads(q, k, a3)):
                same &= torch.equal(a.cpu(), b_)
        e = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, rtol=1e-4, atol=1e-4))
        check(same and ok, f"a3_attention card vs CPU ({mode}): maps "
                           f"identical {same}, max_abs_err {e}")
        log(f"  a3_attention f32 a3={mode}: card vs CPU block maps "
            f"identical, max_abs_err {e:.3g} (tolerance 1e-4); routes "
            f"{routes}")


GEMMA = dict(b=1, hq=8, hkv=4, s=2048, d=256)     # gemma3-4b's attention


def phase_head_dim_256(dev):
    """[7](d): kernels #4-#6 at gemma3-4b's attention width (head dim
    256, which the tensor-core routes do not take) in bf16 and float32,
    causal and with a 1024 window, against their plain versions, every
    call on a CUDA-core route; then, bf16 causal over 4 input sets (64 MB
    > L2), each kernel's time, #4 beside SDPA's at the same shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.a3_attention import kernel as ak
    from repro_torch.kernels.flash_attention import kernel as fk
    b, hq, hkv, s, d = (GEMMA[x] for x in ("b", "hq", "hkv", "s", "d"))

    def qkv(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return tuple(torch.randn(sh, generator=g, device=dev).bfloat16()
                     for sh in ((b, hq, s, d), (b, hkv, s, d),
                                (b, hkv, s, d)))

    q, k, v = qkv(400)
    idx, cnt = random_map(400, dev, shape=GEMMA)
    errs = {"flash": 0.0, "rowmax": 0.0, "attend": 0.0}
    for dtype in ("bf16", "f32"):
        qq, kk, vv = (q, k, v) if dtype == "bf16" else \
            (q.float(), k.float(), v.float())
        for window in (None, 1024):
            fk.reset_launch_counts()
            ak.reset_launch_counts()
            got = {"flash": (fk.flash_attention(qq, kk, vv, window=window),
                             fk.flash_attention_plain(qq, kk, vv,
                                                      window=window))}
            rm = ak.sparse_rowmax(qq, kk, idx, cnt, window=window)
            got["rowmax"] = (rm, ak.sparse_rowmax_plain(qq, kk, idx, cnt,
                                                        window=window))
            got["attend"] = (
                ak.sparse_attend(qq, kk, vv, idx, cnt, rm, threshold=T_CONS,
                                 window=window),
                ak.sparse_attend_plain(qq, kk, vv, idx, cnt, rm,
                                       threshold=T_CONS, window=window))
            for name, (out, want) in got.items():
                e, ok = max_err(out, want)
                check(ok and out.shape == want.shape,
                      f"{name} at head dim 256 ({dtype}, window {window}) "
                      f"disagrees with its plain version: {e}")
                errs[name] = max(errs[name], e)
            routes = {**fk.LAUNCHES, **ak.LAUNCHES}
            want = {name: int(name.endswith("_simt")) for name in routes}
            check(routes == want, f"head dim 256 ({dtype}) took {routes}, "
                                  f"expected the CUDA-core routes")
    log(f"  #4-#6 at head dim 256 vs plain (bf16 and f32, causal and "
        f"window 1024, t={T_CONS}): max_abs_err flash {errs['flash']:.3g}, "
        f"rowmax {errs['rowmax']:.3g}, attend {errs['attend']:.3g}; every "
        f"call on its CUDA-core route")

    sets = [qkv(410 + i) for i in range(4)]
    maps = [random_map(410 + i, dev, shape=GEMMA) for i in range(4)]
    rsets = [(x[0], x[1], *m) for x, m in zip(sets, maps)]
    asets = [(*x, *m, ak.sparse_rowmax(*r))
             for x, m, r in zip(sets, maps, rsets)]

    def sdpa(*x):
        return F.scaled_dot_product_attention(*x, is_causal=True,
                                              enable_gqa=True)

    res = {
        "flash": (cuda_ms(lambda *x: fk.flash_attention(*x), sets, 10),
                  device_ms(lambda *x: fk.flash_attention(*x), sets, 10,
                            True)),
        "SDPA": (cuda_ms(sdpa, sets, 20), device_ms(sdpa, sets, 20)),
        "rowmax": (cuda_ms(lambda *x: ak.sparse_rowmax(*x), rsets, 10),
                   device_ms(lambda *x: ak.sparse_rowmax(*x), rsets, 10,
                             True)),
        "attend": (cuda_ms(lambda *x: ak.sparse_attend(
            *x, threshold=T_CONS), asets, 10), device_ms(
            lambda *x: ak.sparse_attend(*x, threshold=T_CONS), asets, 10,
            True)),
    }
    log("  at head dim 256, bf16 causal (density-0.5 maps for #5/#6): "
        + "; ".join(f"{n} {ms:.4f} ms by events, {fmt_ms(dms)} device"
                    for n, (ms, dms) in res.items()) + f" [{CARD}]")
    _, bounds = prefill_bounds(sets, maps, [a[-1] for a in asets], GEMMA)
    bounds["flash"] = flash_bound(GEMMA)
    log("  bounds at head dim 256 (as [7a] computes them): "
        + "; ".join(f"{n} {bounds[n][0]:.4f} ms ({bounds[n][1]}), device "
                    f"{fmt_ms(res[n][1])} = "
                    + ("not measured" if res[n][1] is None
                       else f"{res[n][1] / bounds[n][0]:.1f}x")
                    for n in ("flash", "rowmax", "attend")) + f" [{CARD}]")
    return res


# ---------------------------------------------------------------------------
# phase 8: xLSTM (kernel #7, xlstm-350m serving, TINY_XL card vs CPU)
# ---------------------------------------------------------------------------

XL = dict(b=4, h=4, s=2048, d=256, chunk=256)      # xlstm-350m's heads
N_XL_SETS = 2          # 2 x 84 MB of q/k/v/h > 50 MB of L2
XL_TOL = dict(rtol=2e-4, atol=2e-4)    # float32 h, sequential vs chunked


def mlstm_inputs(seed, dev, s=None, state=False):
    """bf16 q/k/v [4,4,S,256], float32 gates [4,4,S] (log_i normal, log_f
    a log-sigmoid around 2) and, with ``state``, a random carried (C, n,
    m)."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(seed)
    b, h, d = XL["b"], XL["h"], XL["d"]
    s = s or XL["s"]
    q, k, v = (0.5 * torch.randn((b, h, s, d), generator=g, device=dev)
               for _ in range(3))
    li = torch.randn((b, h, s), generator=g, device=dev)
    lf = F.logsigmoid(torch.randn((b, h, s), generator=g, device=dev) + 2.0)
    st = None
    if state:
        st = (torch.randn((b, h, d, d), generator=g, device=dev),
              torch.randn((b, h, d), generator=g, device=dev),
              torch.randn((b, h), generator=g, device=dev))
    return (q.bfloat16(), k.bfloat16(), v.bfloat16(), li, lf), st


def mlstm_need(b, h, s, chunk, dk, dv, state):
    """(bytes, operations) of one chunk-kernel call: bf16 q/k/v and f32
    gates read once, f32 h written once (and the state read and written);
    per chunk 2 Dk + 2 Dv operations for each causal (t, u) pair, and per
    row q.C, q.n, the k^T V and n updates."""
    L = min(chunk, s)
    pairs = sum(n * (n + 1) // 2 for n in
                [L] * (s // L) + ([s % L] if s % L else []))
    flops = b * h * (pairs * (2 * dk + 2 * dv) + s * (4 * dk * dv + 4 * dk))
    nbytes = b * h * (s * (2 * dk + dv) * 2 + s * 2 * 4 + s * dv * 4)
    if state:
        nbytes += 2 * b * h * (dk * dv + dk + 1) * 4
    return nbytes, flops


def phase_mlstm_kernel(dev):
    """[8](a): kernel #7 vs its plain version at xlstm-350m's shape: zero
    state, a random carried state (also the final state), the served
    prefill dispatch's shape (S=512) and an odd S; then its time, its
    plain version's and its bound."""
    import torch
    from repro_torch.kernels.mlstm_chunk import kernel as mk

    err = 0.0
    mk.reset_launch_counts()
    for name, s, with_state in (("zero state", None, False),
                                ("carried state", None, True),
                                ("carried state, S=512", 512, True),
                                ("zero state, S=300", 300, False)):
        args, st = mlstm_inputs(300 + (s or 0) + with_state, dev, s,
                                with_state)
        kw = dict(chunk=XL["chunk"], scale=XL["d"] ** -0.5, state=st,
                  return_state=True)
        got, gst = mk.mlstm_chunk_kernel(*args, **kw)
        want, wst = mk.mlstm_chunk_plain(*args, **kw)
        sync(dev)
        for a, b_ in ((got, want),) + tuple(zip(gst, wst)):
            ok = bool(torch.allclose(a, b_, **XL_TOL))
            e = float((a - b_).abs().max())
            check(ok and bool(torch.isfinite(a).all()),
                  f"mlstm_chunk kernel disagrees with its plain version "
                  f"({name}): max_abs_err {e}")
        e = float((got - want).abs().max())
        err = max(err, e)
        log(f"  mlstm_chunk ({name}) vs plain: h max_abs_err {e:.3g}, "
            f"final C/n/m within tolerance (atol {XL_TOL['atol']} + rtol "
            f"{XL_TOL['rtol']})")
    check(mk.LAUNCHES == {"mlstm_chunk_wgmma": 4, "mlstm_chunk_simt": 0},
          f"bf16 mlstm_chunk calls at xlstm-350m width took {mk.LAUNCHES}, "
          f"expected the tensor-core route four times")
    log(f"  mlstm_chunk routes at xlstm-350m width, bf16: {mk.LAUNCHES}")
    sets = [mlstm_inputs(400 + i, dev)[0] for i in range(N_XL_SETS)]
    kw = dict(chunk=XL["chunk"], scale=XL["d"] ** -0.5)
    res = dict(
        ms=cuda_ms(lambda *x: mk.mlstm_chunk_kernel(*x, **kw), sets, 20),
        plain_ms=cuda_ms(lambda *x: mk.mlstm_chunk_plain(*x, **kw), sets, 6),
        library_ms=None,
        bound=bound(*mlstm_need(XL["b"], XL["h"], XL["s"], XL["chunk"],
                                XL["d"], XL["d"], False)),
        device_ms=device_ms(lambda *x: mk.mlstm_chunk_kernel(*x, **kw), sets,
                            20, True))
    log(f"  mlstm_chunk (B=4, H=4, S=2048, D=256, chunk 256, zero state): "
        f"kernel {res['ms']:.4f} ms by events, {fmt_ms(res['device_ms'])} "
        f"device, plain {res['plain_ms']:.4f} ms, library not applicable, "
        f"bound {res['bound'][0]:.4f} ms ({res['bound'][1]}) [{CARD}]")
    # the grid the wrapper chose (t_split) beside one CTA per value slice
    chosen = mk.t_split(XL["b"] * XL["h"], XL["d"])
    t_split = mk.t_split
    mk.t_split = lambda bh, dv, sms=mk.SMS: 1
    try:
        one = cuda_ms(lambda *x: mk.mlstm_chunk_kernel(*x, **kw), sets, 20)
        one_dev = device_ms(lambda *x: mk.mlstm_chunk_kernel(*x, **kw), sets,
                            20, True)
    finally:
        mk.t_split = t_split
    log(f"  mlstm_chunk grid: {chosen} CTAs per (batch x head, 64 value "
        f"columns) {res['ms']:.4f} ms ({fmt_ms(res['device_ms'])} device); "
        f"one CTA {one:.4f} ms ({fmt_ms(one_dev)} device) [{CARD}]")
    return err, res


def phase_xlstm_serve(dev):
    """[8](b): xlstm-350m at full width (random bf16 weights from seed 0)
    through ServeEngine: 4 slots, 8 requests of 512-token prompts, 16 new
    tokens, decode_block 1 and 4; kernel #7 must run once per mLSTM layer
    per prefill dispatch."""
    import numpy as np
    import torch
    from repro_torch.config import A3Config, BlockKind, get_arch
    from repro_torch.kernels.mlstm_chunk import kernel as mk
    from repro_torch.models import decoder
    from repro_torch.serve.engine import ServeEngine

    cfg = get_arch("xlstm-350m")
    n_mlstm = sum(cfg.block_kind(i) == BlockKind.MLSTM
                  for i in range(cfg.num_layers))
    t0 = time.perf_counter()
    model = decoder.init_params(cfg, torch.Generator(device=dev).manual_seed(
        0), dev)
    sync(dev)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {cfg.name}: {n_params / 1e9:.3f} B params ({cfg.dtype}), "
        f"{n_mlstm} mLSTM + {cfg.num_layers - n_mlstm} sLSTM layers, random "
        f"init from seed 0 in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=512) for _ in range(8)]

    def serve(reqs, decode_block, max_new, depth=0):
        eng = ServeEngine(model, cfg, slots=4, max_len=1024,
                          decode_block=decode_block, pipeline_depth=depth)
        uids = [eng.submit(p, max_new_tokens=max_new) for p in reqs]
        sync(dev)
        mk.reset_launch_counts()
        t = time.perf_counter()
        eng.run_to_completion()
        sync(dev)
        dt = time.perf_counter() - t
        outs = [eng.result(u) for u in uids]
        check(all(o is not None and len(o) == max_new for o in outs),
              "an xLSTM request did not finish with its full budget")
        check(all(0 <= x < cfg.vocab_size for o in outs for x in o),
              "an xLSTM token lies outside the vocabulary")
        check(mk.LAUNCHES["mlstm_chunk_simt"] == 0,
              f"the bf16 xlstm-350m serve took {mk.LAUNCHES}, expected the "
              f"tensor-core route only")
        return outs, eng.stats, dt, mk.launches()

    serve(prompts[:1], 1, 2)                     # warm-up, not measured
    launches, runs = 0, {}
    for t in (1, 4):
        outs, st, dt, got = serve(prompts, t, 16)
        want = n_mlstm * st["prefill_dispatches"]
        check(got == want > 0, f"mlstm_chunk launched {got} times, expected "
                               f"{n_mlstm} x prefill_dispatches = {want}")
        launches += got
        runs[t] = outs
        n_new = sum(len(o) for o in outs)
        log(f"  serve xlstm-350m decode_block={t}: {n_new} tokens in "
            f"{dt:.3f} s = {n_new / dt:.1f} tok/s; prefill_dispatches "
            f"{st['prefill_dispatches']}, decode_steps {st['decode_steps']}, "
            f"host_syncs {st['host_syncs']}; mlstm_chunk launches {got} = "
            f"{n_mlstm} x {st['prefill_dispatches']} [{CARD}]")
    check(runs[1] == runs[4], "xLSTM tokens differ between decode_block 1 "
                              "and 4")
    # [8b'] the same serve with the harvest deferred one block
    outs, st, dt, got = serve(prompts, 4, 16, depth=1)
    want = n_mlstm * st["prefill_dispatches"]
    check(got == want > 0, f"depth 1: mlstm_chunk launched {got} times, "
                           f"expected {n_mlstm} x prefill_dispatches = {want}")
    check(outs == runs[4], "xLSTM tokens differ between pipeline_depth 0 "
                           "and 1")
    launches += got
    log(f"  [8b'] serve xlstm-350m decode_block=4 depth 1: "
        f"{sum(len(o) for o in outs) / dt:.1f} tok/s, tokens = depth 0's; "
        f"host_syncs {st['host_syncs']}, host_sync_stalls "
        f"{st['host_sync_stalls']}; mlstm_chunk launches {got} = {n_mlstm} "
        f"x {st['prefill_dispatches']} [{CARD}]")
    # one prefill dispatch of the serve (4 fresh lanes x 512 tokens) by
    # the host clock, beside kernel #7 at its shape there by CUDA events
    cache = decoder.init_cache(cfg, 4, 1024, device=dev)
    toks = torch.from_numpy(np.stack(prompts[:4]).astype(np.int32)).to(dev)
    pos = torch.zeros((4,), dtype=torch.int32, device=dev)
    length = torch.full((4,), 512, dtype=torch.int32, device=dev)
    def dispatch():
        decoder.prefill_chunk(model, cfg, cache, toks, pos, length)

    for _ in range(2):                           # the first call warms up
        sync(dev)
        t = time.perf_counter()
        dispatch()
        sync(dev)
    pms = (time.perf_counter() - t) * 1e3
    args, st = mlstm_inputs(500, dev, 512, True)

    def served():
        return mk.mlstm_chunk_kernel(*args, chunk=XL["chunk"],
                                     scale=XL["d"] ** -0.5, state=st,
                                     return_state=True)

    kms = cuda_ms(served, [()], 20)
    kdev = device_ms(served, [()], 20, True)
    log(f"  prefill dispatch (4 lanes x 512 tokens): {pms:.1f} ms; kernel "
        f"#7 at its shape (B=4, H=4, S=512, carried state) {kms:.4f} ms by "
        f"events, {fmt_ms(kdev)} device, x {n_mlstm} launches [{CARD}]")
    busy, n_kernels, k7 = profile_named(dispatch, "mlstm_wgmma_kernel")
    if busy is None:
        log("    dispatch device time: not measured (the profiler saw no "
            "device activity)")
    else:
        log(f"    profiler over one dispatch: device busy {busy:.3f} ms "
            f"({busy / pms:.1%} of the {pms:.1f} ms dispatch), "
            f"{n_kernels:.0f} kernels; #7 {k7:.3f} ms of it ({k7 / busy:.1%}"
            f" of the busy time) [{CARD}]")
    fn = step_fn(model, cfg, A3Config(), False)
    ms = cuda_ms(fn, [()], 20)
    log(f"  decode_step: {ms:.3f} ms per step (B=4, {cfg.num_layers} "
        f"layers) [{CARD}]")
    dev_ms, n_kernels, top, _ = profile_steps(fn)
    if dev_ms is None:
        log("    device time per step: not measured (the profiler saw no "
            "device activity)")
    else:
        log(f"    profiler: device busy {dev_ms:.3f} ms per step "
            f"({dev_ms / ms:.1%} of the {ms:.3f} ms step), {n_kernels:.0f} "
            f"kernels per step; top: "
            + "; ".join(f"{n} {t:.3f} ms" for n, t in top))
    log(f"  peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return launches


def phase_tiny_xl(dev):
    """[8](c): the TINY_XL f32 engine (mLSTM, mLSTM, sLSTM; the shape of
    tests/test_serve_conformance.py's TINY_XL) on the card vs the CPU:
    greedy tokens identical; chunk 8 puts chunk boundaries mid-prompt."""
    from repro_torch.config import A3Config, BlockKind, ModelConfig
    from repro_torch.kernels.mlstm_chunk import kernel as mk

    tiny_xl = ModelConfig("tiny-xl", "ssm", num_layers=3, d_model=64,
                          num_heads=4, num_kv_heads=4, d_ff=0,
                          vocab_size=256, head_dim=16,
                          block_pattern=(BlockKind.MLSTM, BlockKind.MLSTM,
                                         BlockKind.SLSTM), dtype="float32")
    outs = card_vs_cpu_tokens(tiny_xl, dev, A3Config(),
                              mk.reset_launch_counts)
    log(f"  TINY_XL f32: card vs CPU greedy tokens {n_same(outs)}/30 "
        f"identical; card mlstm_chunk launches {mk.LAUNCHES}")
    check(outs["cuda"] == outs["cpu"] and mk.LAUNCHES["mlstm_chunk_simt"] > 0
          and mk.LAUNCHES["mlstm_chunk_wgmma"] == 0,
          "TINY_XL f32 tokens differ between the card and the CPU, or "
          "kernel #7 did not run on its CUDA-core route")


# ---------------------------------------------------------------------------
# phase 9: the later families at full width and depth
# ---------------------------------------------------------------------------

FAMILIES = ("gemma3-4b", "recurrentgemma-2b", "deepseek-moe-16b",
            "h2o-danube-1.8b")
FAMILY_SERVE = dict(slots=4, max_len=2048, prompt_len=1536, max_new=8,
                    decode_block=4)


def attention_layers(cfg, a3_on):
    """(attention layers, those that launch #1): with A^3 on, the layers
    of the segments it applies to take the compact torch path instead."""
    from repro_torch.config import BlockKind
    from repro_torch.models.mixer import build_segments
    segs = build_segments(cfg)
    n = sum(s.count for s in segs if s.kind == BlockKind.ATTENTION)
    return n, n - sum(s.count for s in segs if s.uses_a3(a3_on))


def scaled_err(got, want):
    """(max |got - want|, max |want|, their ratio): the error in units of
    the output's own scale, which the fixed bf16 ``atol`` is not when
    the outputs are far below 1."""
    got, want = got.float(), want.float()
    e, scale = float((got - want).abs().max()), float(want.abs().max())
    return e, scale, e / scale if scale > 0 else float("inf")


def served_fused_check(label, cfg, cache, segs, last, dev):
    """#1 against its plain version on the rings a served model wrote:
    q random (seed 9) at the model's heads, K/V the rings of up to 4
    layers of the segments ``segs`` [(index, SegmentSpec)] (one input set
    each), the mask the ring validity after each lane wrote position
    ``last``, as the A^3-off decode step builds it. Every set must agree
    within the bf16 tolerance and within ``TOL["rtol"]`` of the output's
    largest magnitude; a zeroed output and the plain version with every
    other valid key masked must both fall outside that, so that the
    comparison would see a kernel that returned nothing or dropped keys.
    -> (a row of max error, times and bound; whether the rings
    wrapped)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel as tk
    from repro_torch.models.mixer import _ring_valid_mask

    g = torch.Generator(device=dev).manual_seed(9)
    sets = []
    for si, seg in segs:
        sc = cache[f"seg{si}"]
        for l in range(sc["k"].shape[0]):
            if len(sets) == 4:
                break
            k, v = sc["k"][l].contiguous(), sc["v"][l].contiguous()
            b, hkv, w, d = k.shape
            q = torch.randn((b, cfg.num_heads, d), generator=g,
                            device=dev).to(k.dtype)
            pos = torch.full((b,), last, dtype=torch.int32, device=dev)
            valid = _ring_valid_mask(w, pos, seg.window)
            mask = valid[:, None, :].expand(b, cfg.num_heads, w).contiguous()
            sets.append((q, k, v, mask))
    b, hkv, w, d = sets[0][1].shape
    errs, scales, rels, drops = [], [], [], []
    for i, (q, k, v, mask) in enumerate(sets):
        got, want = tk.fused(q, k, v, mask), tk.fused_plain(q, k, v, mask)
        e, ok = max_err(got, want)
        _, scale, rel = scaled_err(got, want)
        # every other valid key of each row masked
        nth = mask.to(torch.int32).cumsum(-1)
        half = tk.fused_plain(q, k, v, mask & (nth % 2 == 0))
        _, _, drop = scaled_err(half, want)
        check(ok and rel <= TOL["rtol"],
              f"{label} set {i}: fused kernel disagrees with its plain "
              f"version on the served rings: max_abs_err {e:.3g}, max "
              f"|plain| {scale:.3g}, ratio {rel:.3g}")
        check(scale > 0 and drop > TOL["rtol"],
              f"{label} set {i}: the comparison cannot see dropped keys: "
              f"masking every other valid key moves the output by "
              f"{drop:.3g} of max |plain| {scale:.3g}")
        errs.append(e), scales.append(scale), rels.append(rel)
        drops.append(drop)
    e = max(errs)
    out = b * cfg.num_heads * d * 2
    bnd = mean_bound([needed_bytes_flops(*x, x[3], out) for x in sets])
    sdpa_sets = [(x[0][:, :, None], x[1], x[2], x[3][:, :, None])
                 for x in sets]

    def sdpa(q4, k4, v4, m4):
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4,
                                              enable_gqa=True)

    row = dict(model=cfg.name, g=cfg.num_heads // hkv, d=d, s=w,
               ring=label, sets=len(sets), max_abs_err=e,
               max_abs_want=min(scales), max_rel_err=max(rels),
               ms=cuda_ms(lambda *x: tk.fused(*x), sets, 100),
               device_ms=device_ms(lambda *x: tk.fused(*x), sets, 100, True),
               plain_ms=cuda_ms(lambda *x: tk.fused_plain(*x), sets, 10),
               library_ms=cuda_ms(sdpa, sdpa_sets, 100),
               bound_ms=bnd[0], bound_by=bnd[1])
    wrapped = last >= w
    log(f"  #1 on {cfg.name}'s {label} rings (B={b}, G={row['g']}, "
        f"Hkv={hkv}, S={w}, D={d}{', wrapped' if wrapped else ''}; "
        f"{len(sets)} sets, each compared): max_abs_err {e:.3g}, max "
        f"|plain| {min(scales):.3g} to {max(scales):.3g}, error / max "
        f"|plain| at most {max(rels):.3g} (limit {TOL['rtol']}; every "
        f"other key masked moves it {min(drops):.3g} or more); kernel "
        f"{row['ms']:.4f} ms, device {fmt_ms(row['device_ms'])}, plain "
        f"{row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms, bound "
        f"{bnd[0]:.4f} ms ({bnd[1]}) [{CARD}]")
    return row, wrapped


def moe_share(model, cfg, dev, step_busy, bmm_ms):
    """The routed experts' share of a traced decode step: the device
    time of the step's ``aten::bmm`` kernels (``moe_apply``'s batched
    expert SwiGLU over all E x cap rows; an A^3-off decode step has no
    other ``bmm``),
    beside the bound of reading every MoE layer's expert weights once."""
    import torch
    from repro_torch.models.decoder import moe_config
    from repro_torch.models.moe import moe_route

    mc = moe_config(cfg)
    blks = [b for seg in model.segs for b in seg.layers if b.moe is not None]
    x4 = torch.zeros((4, cfg.d_model), device=dev,
                     dtype=blks[0].moe.w_up.dtype)
    cap = moe_route(blks[0].moe, x4, mc)["cap"]
    nbytes = sum(w.numel() * w.element_size() for b in blks
                 for w in (b.moe.w_gate, b.moe.w_up, b.moe.w_down))
    flops = 2 * 3 * mc.num_experts * cap * cfg.d_model * mc.d_expert \
        * len(blks)
    bnd = bound(nbytes, flops)
    if bmm_ms is None:
        log("    routed experts: device time not measured (the trace held "
            "no aten::bmm kernels)")
        return
    log(f"    routed experts (the step's aten::bmm kernels, {len(blks)} MoE "
        f"layers, E x cap = {mc.num_experts} x {cap} rows a layer, "
        f"{4 * mc.top_k} of them routed): {bmm_ms:.3f} ms device = "
        f"{bmm_ms / step_busy:.1%} of the step's {step_busy:.3f} ms device "
        f"busy; bound {bnd[0]:.3f} ms ({bnd[1]}, {nbytes / 1e9:.3f} GB of "
        f"expert weights) [{CARD}]")


def phase_families(dev):
    """[9]: gemma3-4b, recurrentgemma-2b, deepseek-moe-16b and
    h2o-danube-1.8b at full width and depth (random bf16 weights from seed
    0, one model on the card at a time): 4 slots, max_len 2048, 4
    requests of 1536-token prompts, 8 new tokens, decode_block 4, A^3 off
    (gemma3 also conservative); #1's launches per decode step must equal
    the attention layers that take it; #1 against its plain version on
    the rings the A^3-off serve left, before the timed decode steps write
    past them. -> (#1's launches, the served-shape rows)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.config import A3Config, BlockKind, get_arch
    from repro_torch.kernels.decode_attention import kernel as tk
    from repro_torch.models import decoder
    from repro_torch.models.mixer import FULL_WINDOW
    from repro_torch.serve.engine import ServeEngine

    sv = FAMILY_SERVE
    last = sv["prompt_len"] + sv["max_new"] - 2     # last position written
    launches, rows = 0, []
    for arch in FAMILIES:
        cfg = get_arch(arch)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        model = decoder.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        sync(dev)
        n_params = sum(p.numel() for p in model.parameters())
        n_attn, _ = attention_layers(cfg, False)
        log(f"  {arch}: {n_params / 1e9:.3f} B params ({cfg.dtype}), "
            f"{cfg.num_layers} layers, {n_attn} attention, random init "
            f"from seed 0 in {time.perf_counter() - t0:.1f} s")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, size=sv["prompt_len"])
                   for _ in range(sv["slots"])]
        modes = [("off", A3Config())]
        if arch == "gemma3-4b":
            modes.append(("conservative", A3Config.conservative()))
        ref_outs = None
        for mode, a3 in modes:
            def engine():
                return ServeEngine(model, cfg, slots=sv["slots"],
                                   max_len=sv["max_len"], a3=a3,
                                   decode_block=sv["decode_block"])
            warm = engine()                   # not measured
            warm.submit(prompts[0][:16], max_new_tokens=2)
            warm.run_to_completion()
            del warm
            eng = engine()
            uids = [eng.submit(p, max_new_tokens=sv["max_new"])
                    for p in prompts]
            sync(dev)
            tk.reset_launch_counts()
            t = time.perf_counter()
            eng.run_to_completion()
            sync(dev)
            dt = time.perf_counter() - t
            fused = tk.LAUNCHES["decode_attention_fused"]
            outs = [eng.result(u) for u in uids]
            check(all(o is not None and len(o) == sv["max_new"]
                      for o in outs),
                  f"{arch}: a request did not finish with its full budget")
            check(all(0 <= x < cfg.vocab_size for o in outs for x in o),
                  f"{arch}: a generated token lies outside the vocabulary")
            st = eng.stats
            _, per_step = attention_layers(cfg, mode != "off")
            check(fused == per_step * st["decode_steps"] > 0,
                  f"{arch} a3={mode}: fused kernel launched {fused} times, "
                  f"expected {per_step} x decode_steps "
                  f"{st['decode_steps']}")
            launches += fused
            n_new = sum(len(o) for o in outs)
            line = (f"  serve {arch} a3={mode}: {n_new} tokens in {dt:.3f} "
                    f"s = {n_new / dt:.2f} tok/s; prefill_dispatches "
                    f"{st['prefill_dispatches']}, decode_steps "
                    f"{st['decode_steps']}, resorts {st['resorts']}; #1 "
                    f"launches {fused} = {fused / st['decode_steps']:.0f} "
                    f"per decode step")
            if ref_outs is not None:
                agree = sum(a == b for o, r in zip(outs, ref_outs)
                            for a, b in zip(o, r))
                line += f"; tokens agreeing with A^3 off {agree}/{n_new}"
            ref_outs = ref_outs or outs
            log(line + f" [{CARD}]")
            if mode == "off":
                # #1 on the rings as the serve left them, per window kind,
                # before the timed steps below write position last + 1
                kinds = {}
                for si, seg in enumerate(decoder.build_segments(cfg)):
                    if seg.kind == BlockKind.ATTENTION:
                        kinds.setdefault(
                            "global" if seg.window >= FULL_WINDOW
                            else f"window {seg.window}", []).append((si, seg))
                for label, segs in kinds.items():
                    row, wrapped = served_fused_check(label, cfg, eng.cache,
                                                      segs, last, dev)
                    if arch == "gemma3-4b" and label != "global":
                        check(wrapped, "gemma3-4b's local rings did not wrap")
                    rows.append(row)
            # one decode step of the full model on the served cache, at
            # the position after the last one each lane wrote
            tok = torch.zeros((sv["slots"],), dtype=torch.int32, device=dev)
            pos = torch.full((sv["slots"],), last + 1, dtype=torch.int32,
                             device=dev)

            def step():
                decoder.decode_step(model, cfg, eng.cache, tok, pos, a3=a3)
            ms = cuda_ms(step, [()], 5)
            dev_ms, n_kernels, top, bmm_ms = profile_steps(step, steps=2,
                                                           op="aten::bmm")
            if dev_ms is None:
                log(f"    decode_step {ms:.3f} ms; device time not measured "
                    f"(the profiler saw no device activity)")
                continue
            log(f"    decode_step {ms:.3f} ms per step (B=4, position "
                f"{int(pos[0])}); profiler: device busy {dev_ms:.3f} ms "
                f"({dev_ms / ms:.1%} of the step), {n_kernels:.0f} "
                f"kernels per step; top: "
                + "; ".join(f"{n} {x:.3f} ms" for n, x in top)
                + f" [{CARD}]")
            if cfg.moe is not None:
                moe_share(model, cfg, dev, dev_ms, bmm_ms)
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"  peak device memory {peak / 2**30:.2f} GiB, "
            f"{(peak - held) / 2**30:.2f} GiB above the {held / 2**30:.2f} "
            f"GiB held before the model [{CARD}]")
        del model, eng, step
        gc.collect()
        torch.cuda.empty_cache()
    return launches, rows


def phase_tiny_families(dev):
    """[9](b): the tiny float32 configs of the new kinds (the CPU tests'
    TINY_RG, TINY_LG and TINY_MOE) on the card vs the CPU: greedy tokens
    identical, #1 launched on the card."""
    import dataclasses
    from repro_torch.config import A3Config, AttentionKind, BlockKind, \
        ModelConfig, MoEConfig
    from repro_torch.kernels.decode_attention import kernel as tk

    tiny = ModelConfig("tiny", "dense", num_layers=2, d_model=64,
                       num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                       head_dim=16, dtype="float32")
    configs = {
        "TINY_RG": (dataclasses.replace(
            tiny, name="tiny-rg", num_layers=3,
            attention_kind=AttentionKind.SLIDING, window_size=24,
            block_pattern=(BlockKind.RGLRU, BlockKind.RGLRU,
                           BlockKind.ATTENTION), act="gelu"), A3Config()),
        "TINY_LG": (dataclasses.replace(
            tiny, name="tiny-lg", num_layers=4,
            attention_kind=AttentionKind.LOCAL_GLOBAL,
            local_global_pattern=1, window_size=16),
            A3Config.conservative()),
        "TINY_MOE": (dataclasses.replace(
            tiny, name="tiny-moe", num_layers=3,
            moe=MoEConfig(num_experts=4, num_shared=1, top_k=2,
                          d_expert=32, num_dense_layers=1)), A3Config()),
    }
    for name, (cfg, a3) in configs.items():
        outs = card_vs_cpu_tokens(cfg, dev, a3, tk.reset_launch_counts)
        fused = tk.LAUNCHES["decode_attention_fused"]
        log(f"  {name} f32 a3={a3.mode.value}: card vs CPU greedy tokens "
            f"{n_same(outs)}/30 identical; card fused launches {fused}")
        check(outs["cuda"] == outs["cpu"] and fused > 0,
              f"{name} f32 tokens differ between the card and the CPU, or "
              f"#1 did not run")


# ---------------------------------------------------------------------------
# phase 13: training
# ---------------------------------------------------------------------------

TRAIN_XL = dict(batch=4, seq=512, steps=4)        # xlstm-350m, remat full
TRAIN_LM = dict(batch=4, seq=2048, steps=3,      # internlm2-1.8b
                timed_steps=4)
TRAIN_LM_CMP_BATCH = 1     # remat none vs full: none keeps ~3 GB of f32
#                            attention scores a layer per 4 x 2048 tokens


def train_run(cfg, seq, batch, remat, directory, total_steps=100, **opt):
    from repro_torch.config import CheckpointConfig, OptimizerConfig, \
        RunConfig, ShapeConfig, ShapeKind, ShardingConfig
    return RunConfig(
        model=cfg, shape=ShapeConfig("train", ShapeKind.TRAIN, seq, batch),
        optimizer=OptimizerConfig(total_steps=total_steps,
                                  warmup_steps=2, **opt),
        sharding=ShardingConfig(remat=remat),
        checkpoint=CheckpointConfig(directory=directory, save_every=1000,
                                    async_save=False))


def train_batch(run, step, dev):
    import torch
    from repro_torch.data.synthetic import make_lm_batch
    b = make_lm_batch(step, run.shape.global_batch, run.shape.seq_len,
                      run.model.vocab_size, run.seed)
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def loss_and_grads(model, run, batch):
    """(loss, name -> grad) of one batch through ``lm_loss`` at the run's
    remat and ce_chunk."""
    import torch
    from repro_torch.models import decoder
    loss, _ = decoder.lm_loss(model, run.model, batch["tokens"],
                              batch["labels"], remat=run.sharding.remat,
                              ce_chunk=run.sharding.ce_chunk)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def step_probe(num_steps):
    """``train_loop`` hooks for a run of ``num_steps`` steps: a CUDA event
    after each step (the step has ended in the loss's ``.item()``), and a
    torch.profiler trace of device activity around the last step ->
    (hook, events, profiler). The last step is the one traced, so the
    event gaps of the steps before it are timed without the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    events = []
    prof = profile(activities=[ProfilerActivity.CUDA])

    def hook(step, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        if len(events) == num_steps - 1:
            torch.cuda.synchronize()
            prof.start()
        elif len(events) == num_steps:
            torch.cuda.synchronize()
            prof.stop()
    return hook, events, prof


def train_step_figures(run, dev, label, events, prof):
    """Print step ms by CUDA events between the ends of the loop's steps
    after the first and before the traced last one (``events`` and
    ``prof`` from :func:`step_probe`), device ms and kernels of the traced
    step by torch.profiler (device activity only: a CPU-side trace of an
    xlstm-350m step's ~500k ops takes minutes), peak memory (since the
    last reset) and tok/s, with the card."""
    import torch

    sync(dev)
    gaps = [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:-1])]
    ms = sum(gaps) / len(gaps)
    kern = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    dev_ms = busy if busy > 0 else None
    n_kernels = sum(e.count for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:4]
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    tok_s = run.shape.tokens_per_step / (ms / 1e3)
    log(f"  {label}: step {ms:.1f} ms by events (steps 2-{len(events) - 1}"
        ": " + ", ".join(f"{g:.1f}" for g in gaps) + "), "
        + (f"device busy {dev_ms:.1f} ms of the traced step "
           f"{len(events)} ({dev_ms / ms:.1%}), {n_kernels} kernels a step"
           if dev_ms is not None else "device time not measured")
        + f", peak {peak:.2f} GiB, {tok_s:.0f} tok/s [{CARD}]")
    if dev_ms is not None:
        log("    top: " + "; ".join(
            f"{e.key[:50]} {e.self_device_time_total / 1e3:.1f} ms"
            for e in top))


def phase_train_xlstm(dev):
    """[13a]: xlstm-350m at full width and depth (bf16, 21 mLSTM + 3
    sLSTM), batch 4 x 512, remat full: one batch's grads through
    MLSTMChunk (#7 forward) vs the plain chunkwise (on the card), every
    mLSTM parameter's grad finite and non-zero, then 4 steps of
    ``train_loop`` on SyntheticLM with #7 launched 21 x 2 per step ->
    #7 launches of those steps."""
    import tempfile
    import torch
    from repro_torch.config import BlockKind, get_arch
    from repro_torch.kernels.mlstm_chunk import kernel as mk
    from repro_torch.models import xlstm as xl
    from repro_torch.train.loop import train_loop
    from repro_torch.train.step import init_train_state

    cfg = get_arch("xlstm-350m")
    n_mlstm = sum(cfg.block_kind(i) == BlockKind.MLSTM
                  for i in range(cfg.num_layers))
    with tempfile.TemporaryDirectory() as td:
        run = train_run(cfg, TRAIN_XL["seq"], TRAIN_XL["batch"], "full", td)
        t0 = time.perf_counter()
        state = init_train_state(run, torch.Generator(device=dev).manual_seed(
            0), dev)
        sync(dev)
        n_params = sum(p.numel() for p in state.model.parameters())
        log(f"  {cfg.name}: {n_params / 1e9:.3f} B params (bf16), AdamW m/v "
            f"float32, init {time.perf_counter() - t0:.1f} s")
        batch = train_batch(run, 0, dev)            # the loop's first batch
        mk.reset_launch_counts()
        loss_k, g_k = loss_and_grads(state.model, run, batch)
        sync(dev)
        check(mk.LAUNCHES == {"mlstm_chunk_wgmma": 2 * n_mlstm,
                              "mlstm_chunk_simt": 0},
              f"one remat-full fwd+bwd launched #7 {mk.LAUNCHES}, expected "
              f"{2 * n_mlstm} on the tensor-core route (forward and the "
              f"recomputed forward; MLSTMChunk's backward launches none)")
        dead = [n for n, g in g_k.items() if ".mlstm." in n and not (
            bool(torch.isfinite(g).all()) and bool((g != 0).any()))]
        check(not dead, f"mLSTM parameters with a zero or non-finite grad "
                        f"after step 1: {dead[:6]}")
        n_ml = sum(".mlstm." in n for n in g_k)
        # the same batch with the chunk loop in its plain version
        kernel_fn = xl.mlstm_chunk_kernel
        xl.mlstm_chunk_kernel = mk.mlstm_chunk_plain
        try:
            loss_p, g_p = loss_and_grads(state.model, run, batch)
        finally:
            xl.mlstm_chunk_kernel = kernel_fn
        sync(dev)
        scale = max(float(g.float().abs().max()) for g in g_p.values())
        err = max(float((g_k[n].float() - g.float()).abs().max())
                  for n, g in g_p.items())
        worst = max(g_p, key=lambda n: float(
            (g_k[n].float() - g_p[n].float()).abs().max())
            / max(float(g_p[n].float().abs().max()), 1e-30))
        lerr = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        log(f"  grads via #7 vs the plain chunkwise (one batch, bf16): loss "
            f"{float(loss_k):.4f} vs {float(loss_p):.4f} (rel {lerr:.2e}); "
            f"max |grad diff| {err:.3g} = {err / scale:.2e} of max |grad| "
            f"{scale:.3g}; worst tensor relative to its own max: {worst}; "
            f"{n_ml} mLSTM tensors, none zero or non-finite")
        check(err <= 2e-2 * scale and lerr <= 2e-2,
              f"xlstm-350m grads through #7 disagree with the plain "
              f"chunkwise: {err} > 2e-2 x {scale}, or loss rel {lerr}")
        del g_k, g_p
        per_step = []
        hook, events, prof = step_probe(TRAIN_XL["steps"])
        mk.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = train_loop(run, device=dev, num_steps=TRAIN_XL["steps"],
                         state=state, hooks=[
                             lambda s, m: per_step.append(mk.launches()),
                             hook])
        dt = time.perf_counter() - t0
        steps = [b - a for a, b in zip([0] + per_step, per_step)]
        check(steps == [2 * n_mlstm] * TRAIN_XL["steps"]
              and mk.LAUNCHES["mlstm_chunk_simt"] == 0,
              f"#7 launches per xlstm-350m train step {steps} "
              f"({mk.LAUNCHES}), expected {2 * n_mlstm} each")
        losses = out["losses"]
        check(all(math.isfinite(x) for x in losses),
              f"xlstm-350m losses not finite: {losses}")
        log(f"  train_loop {TRAIN_XL['steps']} steps (B={TRAIN_XL['batch']}"
            f", S={TRAIN_XL['seq']}, remat full): loss "
            + " -> ".join(f"{x:.4f}" for x in losses)
            + f" in {dt:.1f} s; #7 per step {steps} = 2 x {n_mlstm} "
            f"(forward + remat recompute), tensor-core route")
        train_step_figures(run, dev,
                           f"xlstm-350m B={TRAIN_XL['batch']} x "
                           f"{TRAIN_XL['seq']} remat full", events, prof)
    return sum(steps)


def phase_train_lm(dev):
    """[13b]: internlm2-1.8b at full width and depth (bf16, AdamW m/v
    float32): 3 steps at remat none and 3 at full from the same weights
    at batch 1 x 2048 (losses within 1e-3 relative), then 4 steps at
    batch 4 x 2048, remat full, ce_chunk 512, timed (the last one
    traced); the model is freed at the end."""
    import tempfile
    import torch
    from repro_torch.config import get_arch
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.loop import train_loop
    from repro_torch.train.step import TrainState, init_train_state

    cfg = get_arch("internlm2-1.8b")
    with tempfile.TemporaryDirectory() as td:
        run = train_run(cfg, TRAIN_LM["seq"], TRAIN_LM_CMP_BATCH, "none", td)
        t0 = time.perf_counter()
        state = init_train_state(run, torch.Generator(device=dev).manual_seed(
            0), dev)
        init = [p.detach().clone() for p in state.model.parameters()]
        sync(dev)
        n_params = sum(p.numel() for p in init)
        opt_gib = sum(t.numel() * t.element_size()
                      for d in (state.opt.m, state.opt.v)
                      for t in d.values()) / 2 ** 30
        log(f"  {cfg.name}: {n_params / 1e9:.3f} B params (bf16), AdamW m/v "
            f"float32 ({opt_gib:.1f} GiB), init "
            f"{time.perf_counter() - t0:.1f} s")
        losses = {}
        for remat in ("none", "full"):
            with torch.no_grad():
                for p, p0 in zip(state.model.parameters(), init):
                    p.copy_(p0)
            state = TrainState(state.model, adamw_init(
                dict(state.model.named_parameters()), run.optimizer))
            r = dataclasses.replace(run, sharding=dataclasses.replace(
                run.sharding, remat=remat))
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            losses[remat] = train_loop(r, device=dev,
                                       num_steps=TRAIN_LM["steps"],
                                       state=state)["losses"]
            dt = time.perf_counter() - t0
            log(f"  B={TRAIN_LM_CMP_BATCH} x {TRAIN_LM['seq']} remat "
                f"{remat}: loss " + " -> ".join(f"{x:.5f}"
                                                for x in losses[remat])
                + f" in {dt:.1f} s, peak "
                f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
                f"[{CARD}]")
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["none"],
                                                      losses["full"]))
        check(all(math.isfinite(x) for x in losses["none"] + losses["full"])
              and rel <= 1e-3,
              f"internlm2-1.8b losses at remat none {losses['none']} and "
              f"full {losses['full']} differ by {rel:.2e} relative")
        log(f"  remat none vs full: losses within {rel:.2e} relative "
            f"(limit 1e-3)")
        del init
        run = train_run(cfg, TRAIN_LM["seq"], TRAIN_LM["batch"], "full", td)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        hook, events, prof = step_probe(TRAIN_LM["timed_steps"])
        t0 = time.perf_counter()
        out = train_loop(run, device=dev, num_steps=TRAIN_LM["timed_steps"],
                         state=state, hooks=[hook])
        log(f"  train_loop B={TRAIN_LM['batch']} x {TRAIN_LM['seq']} remat "
            f"full, ce_chunk {run.sharding.ce_chunk}: loss "
            + " -> ".join(f"{x:.4f}" for x in out["losses"])
            + f" in {time.perf_counter() - t0:.1f} s")
        check(all(math.isfinite(x) for x in out["losses"]),
              f"internlm2-1.8b losses not finite: {out['losses']}")
        train_step_figures(run, dev,
                           f"internlm2-1.8b B={TRAIN_LM['batch']} x "
                           f"{TRAIN_LM['seq']} remat full", events, prof)
        del state, out
    gc.collect()
    torch.cuda.empty_cache()


def cpu_drawn_state(run, dev):
    """A TrainState drawn on the CPU from generator seed 0 and copied to
    ``dev`` (the card and the CPU start from the same bits)."""
    import torch
    from repro_torch.models import decoder
    from repro_torch.train.step import make_train_state
    return make_train_state(decoder.init_params(
        run.model, torch.Generator().manual_seed(0), "cpu").to(dev), run)


def phase_train_tiny(dev):
    """[13c]: TINY and TINY_XL in float32: 4 train steps on the card equal
    the CPU's losses within 1e-4 relative from the same init;
    ``train_with_recovery`` with a crash at step 3 on the card equals the
    uninterrupted card run's last loss within 1e-5 -> #7 launches on the
    card."""
    import tempfile
    import torch
    from repro_torch.config import BlockKind, ModelConfig
    from repro_torch.kernels.mlstm_chunk import kernel as mk
    from repro_torch.train.loop import train_loop, train_with_recovery

    tiny = ModelConfig("tiny", "dense", num_layers=2, d_model=64,
                       num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                       head_dim=16, dtype="float32")
    tiny_xl = ModelConfig("tiny-xl", "ssm", num_layers=3, d_model=64,
                          num_heads=4, num_kv_heads=4, d_ff=0,
                          vocab_size=256, head_dim=16,
                          block_pattern=(BlockKind.MLSTM, BlockKind.MLSTM,
                                         BlockKind.SLSTM), dtype="float32")
    launches = 0
    cpu = torch.device("cpu")
    for cfg in (tiny, tiny_xl):
        with tempfile.TemporaryDirectory() as td:
            run = train_run(cfg, 32, 4, "none", f"{td}/a", total_steps=10,
                            lr=1e-3)
            want = train_loop(run, device=cpu, num_steps=4,
                              state=cpu_drawn_state(run, cpu))["losses"]
            mk.reset_launch_counts()
            got = train_loop(run, device=dev, num_steps=4,
                             state=cpu_drawn_state(run, dev))["losses"]
            card_launches = mk.launches()
            rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            rec_run = dataclasses.replace(run, checkpoint=dataclasses.replace(
                run.checkpoint, directory=f"{td}/b", save_every=2))
            rec = train_with_recovery(
                rec_run, device=dev, num_steps=6, fail_at_step=3,
                init_state=lambda: cpu_drawn_state(rec_run, dev))
            base = train_loop(run, device=dev, num_steps=6,
                              state=cpu_drawn_state(run, dev))["losses"]
        launches += card_launches
        log(f"  {cfg.name} f32: card losses "
            + ", ".join(f"{x:.6f}" for x in got)
            + f" vs CPU within {rel:.2e} relative; recovery (crash at step "
            f"3, restarts {rec['restarts']}) last loss "
            f"{rec['losses'][-1]:.7f} vs uninterrupted {base[-1]:.7f}; "
            f"card #7 launches {card_launches}")
        check(rel <= 1e-4, f"{cfg.name}: card losses {got} differ from the "
                           f"CPU's {want} by {rel:.2e} relative")
        check(rec["restarts"] == [1] and abs(rec["losses"][-1] - base[-1])
              <= 1e-5 * abs(base[-1]),
              f"{cfg.name}: the recovered run's last loss "
              f"{rec['losses'][-1]} differs from the uninterrupted "
              f"{base[-1]} (restarts {rec['restarts']})")
        if cfg is tiny_xl:
            check(card_launches == 2 * 4 and mk.LAUNCHES["mlstm_chunk_wgmma"]
                  == 0, f"TINY_XL train steps launched #7 {mk.LAUNCHES}, "
                        f"expected 2 mLSTM layers x 4 steps on the CUDA-core "
                        f"route")
    return launches


MEMN2N_SMALL = dict(actors=32, places=8, n=24, words=8, d=32, hops=2,
                    steps=700, statements=20, test=256)   # tests/test_memn2n
MEMN2N_EXAMPLE = dict(actors=64, places=16, n=64, words=8, d=64, hops=3,
                      steps=600, statements=48, test=512)  # the example


def memn2n_train(spec, dev, seed0):
    """tests/test_memn2n.py's recipe (batch 64, AdamW lr 1e-2, warmup 10,
    min_lr_ratio 0.3, no decay) on the card -> (params, cfg, test batch,
    final loss, seconds)."""
    import torch
    from repro_torch.config import OptimizerConfig
    from repro_torch.data.babi import generate_babi, make_task
    from repro_torch.models import memn2n
    from repro_torch.optim.adamw import adamw_init, adamw_update

    task = make_task(num_actors=spec["actors"], num_places=spec["places"],
                     max_sentences=spec["n"], max_words=spec["words"])
    cfg = memn2n.MemN2NConfig(vocab_size=task.vocab_size,
                              d_embed=spec["d"], num_hops=spec["hops"],
                              max_sentences=spec["n"],
                              max_words=spec["words"])
    params = memn2n.init_params(cfg, torch.Generator(device=dev).manual_seed(
        0), dev)
    for p in params.values():
        p.requires_grad_(True)
    ocfg = OptimizerConfig(lr=1e-2, warmup_steps=10, total_steps=spec["steps"],
                           weight_decay=0.0, min_lr_ratio=0.3)
    opt = adamw_init(params, ocfg)
    t0 = time.perf_counter()
    for i in range(spec["steps"]):
        # the host makes batch i while the card runs step i - 1
        b = generate_babi(task, 64, spec["statements"], seed=seed0 + i)
        loss = memn2n.loss_fn(params, b, cfg)
        grads = torch.autograd.grad(loss, list(params.values()))
        _, opt, _ = adamw_update(dict(zip(params, grads)), opt, params,
                                 ocfg)
    sync(dev)
    dt = time.perf_counter() - t0
    test = generate_babi(task, spec["test"], spec["statements"], seed=9)
    return ({k: v.detach() for k, v in params.items()}, cfg, test,
            loss.item(), dt)


def captured_mass(aux, sentences):
    """Per example, the exact softmax mass (over the valid sentences) that
    the kept set holds -> [B]."""
    import torch
    from repro_torch.core.post_scoring import masked_softmax
    valid = torch.as_tensor(sentences, device=aux["scores"].device).gt(
        0).any(-1)
    exact = masked_softmax(aux["scores"], valid)
    return (exact * aux["kept"]).sum(-1)


def phase_memn2n(dev):
    """[13d]: MemN2N on bAbI on the card. tests/test_memn2n.py's task:
    exact accuracy > 0.85 and A^3 conservative within 0.05 of it;
    ``answer_with_a3`` over a batch selects each example's candidates as
    for the example alone, on 16 examples. Then examples/babi_memn2n.py's
    task: exact accuracy, the three A^3 settings' accuracy, delta, mean
    candidates per hop and each hop's captured mass (the ``aux`` of
    ``a3_attention_single``)."""
    import torch
    from repro_torch.config import A3Config, A3Mode
    from repro_torch.models import memn2n

    params, cfg, test, loss, dt = memn2n_train(MEMN2N_SMALL, dev, 100)
    base = float(memn2n.accuracy(params, test, cfg))
    cons = float(memn2n.accuracy(params, test, cfg,
                                 A3Config.conservative()))
    log(f"  tests/test_memn2n.py's task ({MEMN2N_SMALL['steps']} steps in "
        f"{dt:.1f} s, last loss {loss:.4f}): exact accuracy {base:.3f}, "
        f"A^3 conservative {cons:.3f} [{CARD}]")
    check(base > 0.85 and cons >= base - 0.05,
          f"MemN2N on the card: exact accuracy {base} (needs > 0.85) or "
          f"conservative A^3 {cons} more than 0.05 below it")
    _, batch_aux = memn2n.answer_with_a3(
        params, test["sentences"][:16], test["question"][:16], cfg,
        A3Config.conservative())
    for i in range(16):
        _, aux = memn2n.answer_with_a3(params, test["sentences"][i],
                                       test["question"][i], cfg,
                                       A3Config.conservative())
        for h in aux:
            check(torch.equal(aux[h]["candidates"],
                              batch_aux[h]["candidates"][i]),
                  f"answer_with_a3 over a batch selects other candidates "
                  f"than for the example alone (example {i}, {h})")
    log("  A^3 candidates over a batch of 16 = each example's alone, "
        "2 hops")
    params, cfg, test, loss, dt = memn2n_train(MEMN2N_EXAMPLE, dev, 1000)
    base = float(memn2n.accuracy(params, test, cfg))
    log(f"  examples/babi_memn2n.py's task ({MEMN2N_EXAMPLE['steps']} steps "
        f"in {dt:.1f} s, last loss {loss:.4f}, n="
        f"{MEMN2N_EXAMPLE['statements']}): exact accuracy {base:.3f} "
        f"[{CARD}]")
    for label, a3 in (("conservative", A3Config.conservative()),
                      ("aggressive", A3Config.aggressive()),
                      ("custom M=n/4 T=8%", A3Config(
                          mode=A3Mode.CUSTOM, m_fraction=0.25,
                          threshold_pct=8.0))):
        logits, aux = memn2n.answer_with_a3(
            params, test["sentences"], test["question"], cfg, a3)
        gold = torch.as_tensor(test["answer"], device=dev).long()
        acc = float((logits.argmax(-1) == gold).float().mean())
        cands = [float(aux[h]["candidates"].sum(-1).float().mean())
                 for h in sorted(aux)]
        mass = [float(captured_mass(aux[h], test["sentences"]).mean())
                for h in sorted(aux)]
        log(f"    A^3 {label}: accuracy {acc:.3f} (delta "
            f"{100 * (acc - base):+.1f}%), mean candidates per hop "
            + ", ".join(f"{c:.1f}" for c in cands)
            + f" of {MEMN2N_EXAMPLE['statements']}, captured mass per hop "
            + ", ".join(f"{m:.4f}" for m in mass))


def phase_train(dev):
    """[13] -> #7 launches of the training paths ([13a]'s train_loop
    steps and [13c]'s card runs)."""
    log("[13a] xlstm-350m training at full width and depth")
    t = time.perf_counter()
    xl_launches = phase_train_xlstm(dev)
    log(f"  [13a] took {time.perf_counter() - t:.1f} s")
    log("[13b] internlm2-1.8b training at full width and depth")
    t = time.perf_counter()
    phase_train_lm(dev)
    log(f"  [13b] took {time.perf_counter() - t:.1f} s")
    log("[13c] TINY and TINY_XL f32 training, card vs CPU, recovery")
    t = time.perf_counter()
    xl_launches += phase_train_tiny(dev)
    log(f"  [13c] took {time.perf_counter() - t:.1f} s")
    log("[13d] MemN2N on bAbI (the paper's workload)")
    t = time.perf_counter()
    phase_memn2n(dev)
    log(f"  [13d] took {time.perf_counter() - t:.1f} s")
    return xl_launches


# ---------------------------------------------------------------------------
# phase 14: the frontend archs from precomputed embeddings
# ---------------------------------------------------------------------------

# musicgen-medium: B=4 x 1000 frames (a 20 s prompt at EnCodec's 50 Hz),
# then 64 decode steps, each fed the next precomputed frame
MUSICGEN = dict(batch=4, frames=1000, new=64)
# internvl2-2b: 256 patches (one 448 x 448 tile) + a 256-token text
# prompt, then 32 greedy text tokens
VLM = dict(batch=4, patches=256, text=256, new=32)
TRAIN_AUDIO = dict(batch=4, seq=1024, steps=3)      # musicgen-medium
FRONTEND_TINY = dict(batch=2, seq=32)


def frontend_decode(model, cfg, dev, prompt, feed, steps, a3, label):
    """Prefill ``prompt`` [B, S, D] (A^3 sort built when ``a3`` is on),
    then ``steps`` decode steps, each fed ``feed(i, logits)``: a
    precomputed frame (``input_embed``) or the greedy token. Returns
    (argmax of each step's input logits [steps, B] on the host, the
    cache, #1 launches of the steps, figures)."""
    import torch
    from repro_torch.config import A3Mode
    from repro_torch.kernels.decode_attention import kernel as tk
    from repro_torch.models import decoder

    use_a3 = a3.mode != A3Mode.OFF
    b, s = prompt.shape[:2]
    max_len = s + steps
    # warm-up of the shapes' kernels on a short prompt (not measured)
    _, c = decoder.prefill(model, cfg, inputs_embeds=prompt[:, :16],
                           max_len=max_len, a3=use_a3)
    del c
    sync(dev)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    logits, cache = decoder.prefill(model, cfg, inputs_embeds=prompt,
                                    max_len=max_len, a3=use_a3)
    t1.record()
    sync(dev)
    prefill_ms = t0.elapsed_time(t1)
    picks = []
    tk.reset_launch_counts()
    t0.record()
    for i in range(steps):
        picks.append(torch.argmax(logits, -1))
        kw = feed(i, picks[-1])
        logits, cache = decoder.decode_step(model, cfg, cache, pos=s + i,
                                            a3=a3, **kw)
    t1.record()
    sync(dev)
    fused = tk.LAUNCHES["decode_attention_fused"]
    step_ms = t0.elapsed_time(t1) / steps
    check(bool(torch.isfinite(logits.float()).all()),
          f"{label}: non-finite logits after {steps} decode steps")
    last_kw = feed(steps - 1, picks[-1])

    def step():                  # rewrites the last position's own row
        decoder.decode_step(model, cfg, cache, pos=s + steps - 1, a3=a3,
                            **last_kw)
    dev_ms, n_kernels, top, _ = profile_steps(step, steps=2)
    figures = dict(prefill_ms=prefill_ms, step_ms=step_ms, dev_ms=dev_ms,
                   kernels=n_kernels, top=top)
    return torch.stack(picks).cpu(), cache, fused, figures


def frontend_arch(arch, dev, make_inputs):
    """[14a] / [14b]: ``arch`` at full width and depth (random bf16
    weights from seed 0), A^3 off then conservative on the same inputs;
    #1 against its plain version on the A^3-off rings (phase 9's
    ``served_fused_check``). -> (#1 launches, the served-shape row)."""
    import torch
    from repro_torch.config import A3Config, get_arch
    from repro_torch.models import decoder

    cfg = get_arch(arch)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    model = decoder.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    sync(dev)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {arch}: {n_params / 1e9:.3f} B params ({cfg.dtype}), "
        f"{cfg.num_layers} layers, Hq {cfg.num_heads}, Hkv "
        f"{cfg.num_kv_heads}, D {cfg.resolved_head_dim}, random init from "
        f"seed 0 in {time.perf_counter() - t0:.1f} s")
    prompt, feed, steps, what = make_inputs(cfg, model)
    n_attn, per_step = attention_layers(cfg, False)
    picks, launches, row = {}, 0, None
    for mode, a3 in (("off", A3Config()),
                     ("conservative", A3Config.conservative())):
        picks[mode], cache, fused, fig = frontend_decode(
            model, cfg, dev, prompt, feed, steps, a3, f"{arch} a3={mode}")
        _, per_step = attention_layers(cfg, mode != "off")
        check(fused == per_step * steps,
              f"{arch} a3={mode}: fused kernel launched {fused} times in "
              f"{steps} decode steps, expected {per_step} a step")
        if mode == "off":
            check(fused > 0, f"{arch}: #1 was not launched")
        launches += fused
        busy = (f"device busy {fig['dev_ms']:.3f} ms "
                f"({fig['dev_ms'] / fig['step_ms']:.1%} of the step), "
                f"{fig['kernels']:.0f} kernels a step; top: "
                + "; ".join(f"{n} {x:.3f} ms" for n, x in fig["top"][:4])
                if fig["dev_ms"] is not None else
                "device time not measured (the profiler saw no device "
                "activity)")
        line = (f"  {arch} a3={mode} ({what}): prefill {fig['prefill_ms']:.1f}"
                f" ms, decode {fig['step_ms']:.3f} ms a step over {steps} "
                f"steps (CUDA events), {busy}; #1 launches {fused} = "
                f"{fused // steps} a step")
        if mode != "off":
            agree = float((picks[mode] == picks["off"]).float().mean())
            line += (f"; argmax agreeing with A^3 off on {agree:.1%} of "
                     f"{picks[mode].numel()} (lane, step) pairs")
        log(line + f" [{CARD}]")
        if mode == "off":
            # #1 on the rings as the off run left them, every slot written
            row, _ = served_fused_check("global", cfg, cache,
                                        [(0, decoder.build_segments(cfg)[0])],
                                        prompt.shape[1] + steps - 1, dev)
        del cache
        gc.collect()
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  peak device memory {peak / 2**30:.2f} GiB, "
        f"{(peak - held) / 2**30:.2f} GiB above the {held / 2**30:.2f} "
        f"GiB held before the model [{CARD}]")
    del model, prompt
    gc.collect()
    torch.cuda.empty_cache()
    return launches, row


def musicgen_inputs(cfg, model):
    """[14a]: B=4 x (1000 + 64) stub EnCodec frames (seed 1): the first
    1000 the prompt, frame 1000 + i the input of decode step i."""
    import torch
    from repro_torch.models.frontend import audio_frame_embeds
    mg = MUSICGEN
    frames = audio_frame_embeds(
        torch.Generator(device=model.device).manual_seed(1), mg["batch"],
        mg["frames"] + mg["new"], cfg)

    def feed(i, _pick):
        return {"input_embed": frames[:, mg["frames"] + i]}
    return (frames[:, :mg["frames"]], feed, mg["new"],
            f"B={mg['batch']} x {mg['frames']} frames, {mg['new']} frames "
            f"fed")


def vlm_inputs(cfg, model):
    """[14b]: 256 stub InternViT patches and a 256-token text prompt from
    ``vlm_sequence`` (seed 1), the text through ``embed_tokens``; each
    decode step fed the greedy token."""
    import torch
    from repro_torch.models import decoder
    from repro_torch.models.frontend import vlm_sequence
    v = VLM
    vis, text = vlm_sequence(
        torch.Generator(device=model.device).manual_seed(1), v["batch"],
        v["patches"] + v["text"], v["patches"], cfg)
    prompt = torch.cat([vis, decoder.embed_tokens(model, cfg, text)], 1)

    def feed(_i, pick):
        return {"token": pick.to(torch.int32)}
    return (prompt, feed, v["new"],
            f"B={v['batch']} x ({v['patches']} patches + {v['text']} text "
            f"tokens), {v['new']} greedy tokens")


def phase_train_audio(dev):
    """[14d]: musicgen-medium training at full width and depth (bf16,
    AdamW m/v float32) on {"embeds", "labels"} batches, B=4 x 1024, remat
    full, 3 steps of ``make_train_step``: losses finite, ``embed``'s
    gradient exactly zero (its m and v stay 0), ``embed`` after the steps
    the AdamW decay-only update of its initial value (within one bf16
    step); step ms, busy share, kernels, peak memory, tok/s."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.config import get_arch
    from repro_torch.models.frontend import audio_frame_embeds
    from repro_torch.optim.adamw import cosine_schedule
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = get_arch("musicgen-medium")
    ta = TRAIN_AUDIO
    run = train_run(cfg, ta["seq"], ta["batch"], "full", None)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = init_train_state(run, torch.Generator(device=dev).manual_seed(0),
                             dev)
    embed0 = state.model.embed.detach().clone()
    sync(dev)
    log(f"  {cfg.name}: {sum(p.numel() for p in state.model.parameters()) / 1e9:.3f}"
        f" B params (bf16), AdamW m/v float32, init "
        f"{time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device=dev).manual_seed(2)
    batches = [{"embeds": audio_frame_embeds(g, ta["batch"], ta["seq"], cfg),
                "labels": torch.randint(0, cfg.vocab_size,
                                        (ta["batch"], ta["seq"]),
                                        generator=g, device=dev,
                                        dtype=torch.int32)}
               for _ in range(ta["steps"])]
    step = make_train_step(run)
    events, losses = [], []
    prof = profile(activities=[ProfilerActivity.CUDA])
    for i, batch in enumerate(batches):
        if i == ta["steps"] - 1:
            sync(dev)
            prof.start()
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
    sync(dev)
    prof.stop()
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses),
          f"musicgen-medium losses not finite: {losses}")
    check(not state.opt.m["embed"].any() and not state.opt.v["embed"].any(),
          "musicgen-medium: embed got a non-zero gradient from an embeds "
          "batch (its AdamW moments moved)")
    want = embed0.float()
    for i in range(1, ta["steps"] + 1):
        lr = cosine_schedule(run.optimizer, torch.tensor(i, device=dev))
        want = (want - lr * (run.optimizer.weight_decay * want)).to(
            torch.bfloat16).float()
    got = state.model.embed.detach().float()
    ulp = (2.0 ** -7) * want.abs()
    err = float(((got - want).abs() - ulp).max())
    moved = float((got - embed0.float()).abs().max())
    # lr x weight_decay (~1e-5 in these warm-up steps) is below bf16's
    # resolution, so the decay-only update may leave the table as it was
    check(err <= 0, f"musicgen-medium: embed after {ta['steps']} steps is "
                    f"not the decay-only AdamW update (max excess over one "
                    f"bf16 step {err}, moved {moved})")
    log(f"  {ta['steps']} steps on embeds batches (B={ta['batch']} x "
        f"{ta['seq']}, remat full): loss "
        + " -> ".join(f"{x:.4f}" for x in losses)
        + f"; embed's grad exactly zero (m, v stay 0), embed = the "
        f"decay-only update within one bf16 step (the table moved up to "
        f"{moved:.3g})")
    train_step_figures(run, dev, f"musicgen-medium B={ta['batch']} x "
                       f"{ta['seq']} remat full (embeds)", events, prof)
    del state, batches, step, embed0
    gc.collect()
    torch.cuda.empty_cache()


def frontend_tiny_run(base, cfg, d, emb, text, labels):
    """[14e] on device ``d`` from a copy of ``base``: (forward, prefill
    and decode_step logits on the CPU, internvl2's layout's 6 greedy
    tokens [6, B], 2 embeds train-step losses)."""
    import torch
    from repro_torch.models import decoder
    from repro_torch.train.step import make_train_step, make_train_state

    s = emb.shape[1]
    model = copy.deepcopy(base).to(d)
    e = emb.to(d)
    full, _ = decoder.forward(model, cfg, inputs_embeds=e)
    lp, cache = decoder.prefill(model, cfg, inputs_embeds=e[:, :-1],
                                max_len=s + 8)
    ld, _ = decoder.decode_step(model, cfg, cache, pos=s - 1,
                                input_embed=e[:, -1])
    # internvl2's layout: 16 patches, 16 text tokens, 6 greedy steps
    seq = torch.cat([e[:, :16], decoder.embed_tokens(model, cfg,
                                                     text.to(d))], 1)
    lg, cache = decoder.prefill(model, cfg, inputs_embeds=seq, max_len=s + 8)
    toks = []
    for i in range(6):
        toks.append(torch.argmax(lg, -1).to(torch.int32))
        lg, cache = decoder.decode_step(model, cfg, cache, toks[-1],
                                        seq.shape[1] + i)
    run = train_run(cfg, s, emb.shape[0], "none", None, total_steps=10,
                    lr=1e-3)
    state, step, losses = make_train_state(model, run), \
        make_train_step(run), []
    for _ in range(2):
        state, m = step(state, {"embeds": e, "labels": labels.to(d)})
        losses.append(float(m["loss"]))
    return ([x.detach().cpu() for x in (full, lp, ld)],
            torch.stack(toks).cpu(), losses)


def phase_frontend_tiny(dev):
    """[14e]: the smoke variants of both frontend archs in float32, drawn
    on the CPU from seed 0, on the card vs the CPU with the same numpy
    embeddings: forward, prefill and decode_step logits within 1e-5;
    internvl2's patches + text then 6 greedy tokens equal; 2 train steps
    on an embeds batch, losses within 1e-6 relative. -> #1 launches on
    the card."""
    import numpy as np
    import torch
    from repro_torch.config import get_arch, smoke_variant
    from repro_torch.kernels.decode_attention import kernel as tk
    from repro_torch.models import decoder

    cpu = torch.device("cpu")
    b, s = FRONTEND_TINY["batch"], FRONTEND_TINY["seq"]
    launches = 0
    for arch in ("musicgen-medium", "internvl2-2b"):
        cfg = dataclasses.replace(smoke_variant(get_arch(arch)),
                                  dtype="float32")
        rng = np.random.default_rng(3)
        emb = torch.from_numpy(rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32))
        text = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=(b, 16)).astype(np.int32))
        labels = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=(b, s)).astype(np.int32))
        base = decoder.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
        tk.reset_launch_counts()
        want, got = (frontend_tiny_run(base, cfg, d, emb, text, labels)
                     for d in (cpu, dev))
        launches += tk.LAUNCHES["decode_attention_fused"]
        errs = [float((g - w).abs().max()) for g, w in zip(got[0], want[0])]
        rel = max(abs(g - w) / abs(w) for g, w in zip(got[2], want[2]))
        same = torch.equal(got[1], want[1])
        log(f"  {arch} smoke f32, card vs CPU: forward / prefill / decode "
            f"logits within {errs[0]:.2e} / {errs[1]:.2e} / {errs[2]:.2e} "
            f"(limit 1e-5); greedy tokens after patches + text "
            f"{'equal' if same else 'DIFFER'}; train losses "
            + ", ".join(f"{x:.7f}" for x in got[2])
            + f" within {rel:.2e} relative (limit 1e-6); card #1 launches "
            f"{tk.LAUNCHES['decode_attention_fused']}")
        check(max(errs) <= 1e-5, f"{arch}: card logits differ from the CPU's "
                                 f"by {errs}")
        check(same, f"{arch}: card greedy tokens {got[1].tolist()} != "
                    f"CPU's {want[1].tolist()}")
        check(rel <= 1e-6, f"{arch}: card train losses {got[2]} vs CPU "
                           f"{want[2]}")
        check(tk.LAUNCHES["decode_attention_fused"] > 0,
              f"{arch}: #1 not launched on the card")
    return launches


def phase_examples(dev):
    """[14f]: ``examples/quickstart_torch.py`` and
    ``examples/serve_lm_torch.py`` (its defaults: phi4-mini-3.8b's smoke
    variant) on the card, both started together; each must exit 0."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / name)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in ("quickstart_torch.py", "serve_lm_torch.py")}
    try:
        for name, p in procs.items():
            t0 = time.perf_counter()
            text, _ = p.communicate(timeout=300)
            lines = text.strip().splitlines()
            log(f"  examples/{name}: exit {p.returncode} "
                f"({time.perf_counter() - t0:.1f} s waited); last lines:")
            for ln in lines[-4:]:
                log(f"    {ln[:160]}")
            check(p.returncode == 0, f"examples/{name} exited "
                                     f"{p.returncode}:\n{text[-2000:]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def phase_frontend(dev):
    """[14] -> (#1 launches of [14a], [14b] and [14e]'s card runs, the
    served-shape rows of [14c])."""
    log("[14a] musicgen-medium from stub EnCodec frames at full width and "
        "depth")
    t = time.perf_counter()
    launches, rows = 0, []
    n, row = frontend_arch("musicgen-medium", dev, musicgen_inputs)
    launches += n
    rows.append(row)
    log(f"  [14a] took {time.perf_counter() - t:.1f} s")
    log("[14b] internvl2-2b from stub InternViT patches + text at full "
        "width and depth")
    t = time.perf_counter()
    n, row = frontend_arch("internvl2-2b", dev, vlm_inputs)
    launches += n
    rows.append(row)
    log(f"  [14b] took {time.perf_counter() - t:.1f} s")
    log("[14c] #1 vs its plain version on the served rings: see the '#1 on' "
        "lines of [14a] and [14b] (musicgen-medium G=1, D=64; internvl2-2b "
        "G=2, D=128)")
    log("[14d] musicgen-medium training on embeds batches at full width")
    t = time.perf_counter()
    phase_train_audio(dev)
    log(f"  [14d] took {time.perf_counter() - t:.1f} s")
    log("[14e] the smoke variants in float32, card vs CPU")
    t = time.perf_counter()
    launches += phase_frontend_tiny(dev)
    log(f"  [14e] took {time.perf_counter() - t:.1f} s")
    log("[14f] examples/quickstart_torch.py and examples/serve_lm_torch.py "
        "on the card")
    t = time.perf_counter()
    phase_examples(dev)
    log(f"  [14f] took {time.perf_counter() - t:.1f} s")
    return launches, rows


# ---------------------------------------------------------------------------
# phase 15: the device mesh (one NCCL rank on the card, four gloo ranks on
# the CPU)
# ---------------------------------------------------------------------------

MESH_LM = dict(batch=4, seq=2048, steps=3)       # internlm2-1.8b
MESH_XL = dict(batch=4, seq=512, steps=3)        # xlstm-350m
MESH_TINY_STEPS = 3
MESH_CPU_WORLD = 4                               # a (data 2, model 2) mesh


def mesh_tiny_run():
    """TINY in float32 (tests/test_serve_conformance's config), B=8 x 16,
    remat none: the run both the card's one-rank mesh and the CPU's four
    gloo ranks train."""
    from repro_torch.config import ModelConfig
    tiny = ModelConfig("tiny", "dense", num_layers=2, d_model=64,
                       num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                       head_dim=16, dtype="float32")
    run = train_run(tiny, 16, 8, "none", None, total_steps=10, lr=1e-3)
    return dataclasses.replace(run, optimizer=dataclasses.replace(
        run.optimizer, warmup_steps=1))


def mesh_tiny_losses(run, dev, mesh):
    """MESH_TINY_STEPS sharded steps of ``run`` on ``mesh`` from a
    CPU-drawn init (generator seed 0) -> losses."""
    import torch
    from repro_torch.models import decoder
    from repro_torch.train.step import make_train_state, make_train_step
    state = make_train_state(decoder.init_params(
        run.model, torch.Generator().manual_seed(0), "cpu").to(dev), run,
        mesh)
    step = make_train_step(run, mesh)
    losses = []
    for i in range(MESH_TINY_STEPS):
        state, m = step(state, train_batch(run, i, dev))
        losses.append(float(m["loss"]))
    return losses


def mesh_rank_main(argv):
    """``chip_smoke.py --mesh-rank RANK STORE OUT``: one of the CPU gloo
    ranks of [15d] (no card): TINY's sharded losses on a (data 2, model 2)
    mesh, written by rank 0 to OUT as JSON."""
    rank, store, out = int(argv[0]), argv[1], argv[2]
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_mesh
    torch.set_num_threads(1)
    init_distributed("cpu", rank=rank, world_size=MESH_CPU_WORLD,
                     init_method=f"file://{store}")
    try:
        mesh = make_mesh((2, MESH_CPU_WORLD // 2), ("data", "model"), "cpu")
        losses = mesh_tiny_losses(mesh_tiny_run(), torch.device("cpu"), mesh)
        if rank == 0:
            Path(out).write_text(json.dumps(losses))
    finally:
        dist.destroy_process_group()
    return 0


def start_cpu_ranks(directory):
    """Start [15d]'s CPU gloo ranks in the background -> (processes,
    result path)."""
    import os
    store, out = Path(directory) / "store", Path(directory) / "losses.json"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank", str(r),
         str(store), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(MESH_CPU_WORLD)]
    return procs, out


def finish_cpu_ranks(procs, out, timeout=300):
    """Wait for the CPU ranks (killing any still running at the timeout)
    -> their losses."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(all(p.returncode == 0 for p in procs) and out.exists(),
          "[15d] the CPU gloo ranks failed:\n" + "\n".join(
              log[-2000:] for log in logs))
    return json.loads(out.read_text())


def mesh_full_width(arch, shape, dev, mesh):
    """[15a]/[15b]: ``arch`` at full width and depth (bf16, AdamW m/v
    float32), remat full, ``shape``'s batch and steps: the unsharded step
    and the sharded step on the one-rank mesh, each from generator seed 0
    on the card and the same SyntheticLM batches, one model on the card
    at a time -> (unsharded losses, sharded losses, #7 launches of the
    sharded steps)."""
    import torch
    from repro_torch.kernels.mlstm_chunk import kernel as mk
    from repro_torch.config import get_arch
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = get_arch(arch)
    run = train_run(cfg, shape["seq"], shape["batch"], "full", None)
    out, launches = {}, None
    for label, m in (("unsharded", None), ("sharded", mesh)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        state = init_train_state(run, torch.Generator(device=dev).manual_seed(
            0), dev, m)
        step = make_train_step(run, m)
        batches = [train_batch(run, i, dev) for i in range(shape["steps"])]
        sync(dev)
        mk.reset_launch_counts()
        losses, ends = [], []
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for b in batches:
            state, metrics = step(state, b)
            losses.append(float(metrics["loss"]))
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
        sync(dev)
        if m is not None:
            launches = mk.launches()
        ms = [a.elapsed_time(b) for a, b in zip([start] + ends[:-1], ends)]
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        log(f"  {arch} {label}{' (one-rank mesh)' if m is not None else ''}"
            f" B={shape['batch']} x {shape['seq']} remat full: loss "
            + " -> ".join(f"{x:.6f}" for x in losses)
            + "; step ms " + ", ".join(f"{x:.1f}" for x in ms)
            + f" (CUDA events; {time.perf_counter() - t0:.1f} s), peak "
            f"{peak:.2f} GiB, #7 {mk.launches()} [{CARD}]")
        out[label] = losses
        del state, step, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out["unsharded"], out["sharded"], launches


def mesh_primitives(dev, mesh):
    """[15c] on CUDA tensors: ``psum_compressed`` over a one-rank pod
    axis, ``pipeline_forward`` through one stage, the compressed sharded
    step, and a sharded TINY train state saved and restored through the
    mesh checkpoint path."""
    import tempfile
    import torch
    from repro_torch.config import CheckpointConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import decoder
    from repro_torch.sharding.compression import psum_compressed
    from repro_torch.sharding.pipeline import pipeline_forward
    from repro_torch.train.checkpoint import CheckpointManager, _flatten
    from repro_torch.train.step import empty_train_state, make_train_state, \
        make_train_step

    gen = torch.Generator(device=dev).manual_seed(5)
    pods = make_mesh((1, 1, 1), ("pod", "data", "model"), "cuda")
    g = torch.randn(1 << 20, generator=gen, device=dev)
    mean, err = psum_compressed({"g": g}, pods.get_group("pod"))
    half_step = float(g.abs().max()) / 127 / 2
    gap = float((mean["g"] - g).abs().max())
    back = float((mean["g"] + err["g"] - g).abs().max())
    check(gap <= half_step * (1 + 1e-5) and back <= 1e-6,
          f"[15c] psum_compressed on the card: |mean - g| {gap} > half a "
          f"step {half_step}, or mean + err misses g by {back}")
    pipe = make_mesh((1,), ("pipe",), "cuda")
    w = torch.randn((1, 256, 256), generator=gen, device=dev) * 0.06
    x = torch.randn((8, 2, 128, 256), generator=gen, device=dev)
    out = pipeline_forward(lambda p, h: torch.tanh(h @ p["w"]), {"w": w}, x,
                           pipe)
    # the stage on each microbatch alone: the same GEMM shapes, so the
    # same cuBLAS kernels and sums
    check(torch.equal(out, torch.stack([torch.tanh(xm @ w[0]) for xm in x])),
          "[15c] pipeline_forward through one stage differs from the stage")
    run = mesh_tiny_run()
    comp = dataclasses.replace(run, sharding=dataclasses.replace(
        run.sharding, grad_compression=True))
    state = make_train_state(decoder.init_params(
        run.model, torch.Generator().manual_seed(0), "cpu").to(dev), comp,
        pods)
    state, metrics = make_train_step(comp, pods)(state,
                                                 train_batch(comp, 0, dev))
    check(math.isfinite(float(metrics["loss"])),
          "[15c] the compressed sharded step's loss is not finite")
    with tempfile.TemporaryDirectory() as td:
        mgr = CheckpointManager(CheckpointConfig(directory=td), mesh=mesh)
        state = make_train_state(decoder.init_params(
            run.model, torch.Generator().manual_seed(0), "cpu").to(dev), run,
            mesh)
        state, _ = make_train_step(run, mesh)(state, train_batch(run, 0, dev))
        mgr.save(1, state)
        restored, _ = mgr.restore(empty_train_state(run, dev, mesh))
        same = all(torch.equal(a.full_tensor() if hasattr(a, "full_tensor")
                               else a,
                               b.full_tensor() if hasattr(b, "full_tensor")
                               else b)
                   for (_, a), (_, b) in zip(_flatten(state),
                                             _flatten(restored)))
    check(same, "[15c] a sharded train state saved and restored on the card "
                "differs")
    log(f"  [15c] psum_compressed over 2^20 floats: |mean - g| {gap:.3g} "
        f"<= half a step {half_step:.3g}, mean + err = g within {back:.1g}; "
        f"pipeline_forward = the stage; compressed step loss "
        f"{float(metrics['loss']):.6f}; checkpoint save / restore "
        f"bit-equal ({len(list(_flatten(state)))} leaves)")


def phase_mesh(dev):
    """[15] -> #7 launches of [15b]'s sharded xlstm-350m steps."""
    import socket
    import tempfile
    import torch.distributed as dist
    from repro_torch.config import BlockKind, get_arch
    from repro_torch.launch.mesh import init_distributed, make_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed("cuda", rank=0, world_size=1,
                     init_method=f"tcp://127.0.0.1:{port}")
    try:
        with tempfile.TemporaryDirectory() as td:
            procs, out = start_cpu_ranks(td)
            try:
                mesh = make_mesh((1, 1), ("data", "model"), "cuda")
                log("[15a] internlm2-1.8b, unsharded and on the one-rank "
                    "mesh")
                t = time.perf_counter()
                want, got, _ = mesh_full_width("internlm2-1.8b", MESH_LM, dev,
                                               mesh)
                rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
                check(rel <= 1e-5, f"[15a] internlm2-1.8b sharded losses {got} "
                                   f"differ from the unsharded {want} "
                                   f"({rel:.2e} relative)")
                log(f"  [15a] losses equal within {rel:.2e} relative "
                    f"(limit 1e-5); {time.perf_counter() - t:.1f} s")
                log("[15b] xlstm-350m, unsharded and on the one-rank mesh")
                t = time.perf_counter()
                want, got, launches = mesh_full_width("xlstm-350m", MESH_XL,
                                                      dev, mesh)
                rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
                check(rel <= 1e-5, f"[15b] xlstm-350m sharded losses {got} "
                                   f"differ from the unsharded {want} "
                                   f"({rel:.2e} relative)")
                xl = get_arch("xlstm-350m")
                n_mlstm = sum(xl.block_kind(i) == BlockKind.MLSTM
                              for i in range(xl.num_layers))
                check(launches == 2 * n_mlstm * MESH_XL["steps"],
                      f"[15b] #7 launched {launches} times in the sharded "
                      f"steps, expected 2 x {n_mlstm} a step")
                log(f"  [15b] losses equal within {rel:.2e} relative "
                    f"(limit 1e-5); #7 {launches} = 2 x {n_mlstm} x "
                    f"{MESH_XL['steps']}; {time.perf_counter() - t:.1f} s")
                log("[15c] psum_compressed, pipeline_forward, the compressed "
                    "step and a mesh checkpoint on CUDA tensors")
                mesh_primitives(dev, mesh)
                log("[15d] TINY f32 sharded: the card's one-rank mesh vs four "
                    "gloo CPU ranks on a (data 2, model 2) mesh")
                card = mesh_tiny_losses(mesh_tiny_run(), dev, mesh)
            finally:
                cpu = finish_cpu_ranks(procs, out)
            rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
            log(f"  [15d] card losses " + ", ".join(f"{x:.7f}" for x in card)
                + f"; CPU ranks " + ", ".join(f"{x:.7f}" for x in cpu)
                + f"; within {rel:.2e} relative (limit 2e-5)")
            check(rel <= 2e-5, f"[15d] the card's sharded TINY losses {card} "
                               f"differ from the CPU ranks' {cpu}")
    finally:
        dist.destroy_process_group()
    return launches


# ---------------------------------------------------------------------------

def main() -> int:
    global CARD
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is not beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import resolve_device
    from repro_torch.config import get_arch
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    resolve_device("cuda")
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(CARD)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    sources = sorted(p.name for p in build.CSRC.glob("*.cu"))
    paths = build.build_all(sources)
    log(f"[1] built {sources} in {time.perf_counter() - t0:.1f} s -> "
        f"{[str(p.relative_to(ROOT)) for p in paths.values()]}")
    for src, text in build.BUILD_LOGS.items():
        for fn, props in ptxas_report(text):
            log(f"    ptxas {src} {fn}: {props}")

    log("[2] kernels vs plain versions (B=4, Hq=24, Hkv=8, S=512, D=128, "
        "bf16)")
    dev = torch.device("cuda")
    errs, times = phase_kernels(dev)
    log("[3-4] full-width serve, phi4-mini-3.8b")
    cfg = get_arch("phi4-mini-3.8b")
    _, main_launches, ring, model = phase_serve(dev, cfg)
    log("[3b] the engine at phi4-mini-3.8b width: pipeline_depth 0 / 1, "
        "temperature 0.8, a synchronizing-call check, the lifecycle")
    t3b = time.perf_counter()
    main_launches += phase_engine(model, cfg, dev)
    log(f"  phase [3b] took {time.perf_counter() - t3b:.1f} s")
    log("[10] the paged prefix cache at phi4-mini-3.8b width: 8 requests "
        "sharing a 1024-token prefix, cold / fp pool / int8 pool")
    t10 = time.perf_counter()
    main_launches += phase_prefix(model, cfg, dev)
    log("[10b] TINY, TINY_RG, TINY_XL f32 with fp and int8 pools, card vs "
        "CPU")
    prefix_mlstm = phase_prefix_tiny(dev)
    log(f"  phase [10] took {time.perf_counter() - t10:.1f} s")
    log("[11] durable serving state at phi4-mini-3.8b width: the L2 tier, "
        "restore_corrupt, checkpoint / restore, chaos")
    t11 = time.perf_counter()
    main_launches += phase_l2(model, cfg, dev)
    ck_launches, free = phase_checkpoint(model, cfg, dev)
    main_launches += ck_launches + phase_chaos(model, cfg, dev, free)
    prefix_mlstm += phase_durable_tiny(dev)
    log(f"  phase [11] took {time.perf_counter() - t11:.1f} s")
    log("[12] the serving telemetry plane at phi4-mini-3.8b width: A^3 off "
        "/ conservative, pipeline_depth 0 / 1, telemetry off / every 1 / "
        "every 8")
    t12 = time.perf_counter()
    main_launches += phase_telemetry(model, cfg, dev)
    log("[12b] TINY, TINY_RG, TINY_XL f32 with telemetry, card vs CPU")
    prefix_mlstm += phase_telemetry_tiny(dev)
    log(f"  phase [12] took {time.perf_counter() - t12:.1f} s")
    log("[5] two-pass path")
    two_pass = phase_two_pass(ring, dev)
    log("[6] TINY f32, card vs CPU")
    phase_tiny(dev)
    log("[7] A^3 prefill attention at phi4-mini width (B=1, Hq=24, Hkv=8, "
        "S=2048, D=128, bf16, causal)")
    t7 = time.perf_counter()
    perrs, ptimes = phase_prefill_kernels(dev)
    prefill_launches = phase_prefill_path(model, cfg, dev)
    phase_prefill_cpu(dev)
    log("[7d] kernels #4-#6 at gemma3-4b's attention width (B=1, Hq=8, "
        "Hkv=4, S=2048, D=256)")
    phase_head_dim_256(dev)
    log(f"  phase [7] took {time.perf_counter() - t7:.1f} s")
    log("[8] xLSTM: chunkwise mLSTM kernel #7 at xlstm-350m width (B=4, "
        "H=4, S=2048, D=256, bf16 streams), xlstm-350m serving, TINY_XL")
    t8 = time.perf_counter()
    xerr, xtimes = phase_mlstm_kernel(dev)
    xl_launches = phase_xlstm_serve(dev) + prefix_mlstm
    phase_tiny_xl(dev)
    log(f"  phase [8] took {time.perf_counter() - t8:.1f} s")
    log("[9] the later families at full width and depth (gemma3-4b, "
        "recurrentgemma-2b, deepseek-moe-16b, h2o-danube-1.8b), TINY_RG, "
        "TINY_LG, TINY_MOE")
    t9 = time.perf_counter()
    fam_launches, served = phase_families(dev)
    main_launches += fam_launches
    phase_tiny_families(dev)
    log(f"  phase [9] took {time.perf_counter() - t9:.1f} s")
    del model, ring
    gc.collect()
    torch.cuda.empty_cache()
    log("[13] training: xlstm-350m and internlm2-1.8b at full width, TINY "
        "and TINY_XL card vs CPU, MemN2N on bAbI")
    t13 = time.perf_counter()
    xl_launches += phase_train(dev)
    log(f"  phase [13] took {time.perf_counter() - t13:.1f} s")
    log("[14] the frontend archs from precomputed embeddings: "
        "musicgen-medium and internvl2-2b at full width and depth, #1 on "
        "their rings, musicgen training, smoke variants card vs CPU, the "
        "quickstart and serve_lm examples")
    t14 = time.perf_counter()
    fe_launches, fe_served = phase_frontend(dev)
    main_launches += fe_launches
    served += fe_served
    log(f"  phase [14] took {time.perf_counter() - t14:.1f} s")
    log("[15] the device mesh: internlm2-1.8b and xlstm-350m sharded on a "
        "one-rank NCCL mesh vs unsharded, the mesh primitives on CUDA "
        "tensors, TINY on four gloo CPU ranks vs the card")
    t15 = time.perf_counter()
    xl_launches += phase_mesh(dev)
    log(f"  phase [15] took {time.perf_counter() - t15:.1f} s")

    src = "src/repro_torch/csrc/decode_attention.cu"
    jax_kernel = "src/repro/kernels/decode_attention/kernel.py"
    rows = []
    for name, line, launches in (
            ("fused", 98, main_launches),
            ("rowmax", 45, two_pass["decode_attention_rowmax"]),
            ("attend", 66, two_pass["decode_attention_attend"])):
        r = times[name]
        rows.append({"name": f"decode_attention_{name}", "route": "cuda",
                     "source": src, "replaces": f"{jax_kernel}:{line}",
                     "launches": launches, "max_abs_err": errs[name],
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                     "library_ms": r["library_ms"]})
        rows[-1]["device_ms"] = r["device_ms"]
        rows[-1]["s4096"] = r["s4096"]
        if name == "fused":
            rows[-1]["served_shapes"] = served
    for name, key, src, jax_kernel, line, counted in (
            ("flash_attention", "flash", "flash_attention.cu",
             "flash_attention/kernel.py", 23, "flash_attention_wgmma"),
            ("a3_sparse_rowmax", "rowmax", "a3_attention.cu",
             "a3_attention/kernel.py", 60, "a3_sparse_rowmax_wgmma"),
            ("a3_sparse_attend", "attend", "a3_attention.cu",
             "a3_attention/kernel.py", 94, "a3_sparse_attend_wgmma")):
        r = ptimes[key]
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{src}",
                     "replaces": f"src/repro/kernels/{jax_kernel}:{line}",
                     "launches": prefill_launches[counted],
                     "max_abs_err": perrs[key], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                     "bound_by": r["bound"][1],
                     "library_ms": r["library_ms"]})
        if "device_ms" in r:
            rows[-1]["device_ms"] = r["device_ms"]
    rows.append({"name": "mlstm_chunk", "route": "cuda",
                 "source": "src/repro_torch/csrc/mlstm_chunk.cu",
                 "replaces": "src/repro/kernels/mlstm_chunk/kernel.py:34",
                 "launches": xl_launches, "max_abs_err": xerr,
                 "ms": xtimes["ms"], "plain_ms": xtimes["plain_ms"],
                 "bound_ms": xtimes["bound"][0],
                 "bound_by": xtimes["bound"][1], "library_ms": None,
                 "device_ms": xtimes["device_ms"]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_main(sys.argv[2:]))
    sys.exit(main())
