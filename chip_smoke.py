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
   and float32); prints each cluster size; times each kernel with CUDA
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
   row); each kernel timed over inputs larger than L2 beside its plain
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

Prints one JSON line of per-kernel numbers (every row with
``device_ms``, the profiler's device time per launch; rows #1-#3 with
``s4096``, the long ring's ms, device ms and bound; row #1 with
``served_shapes``, phase 9's rows), then, last,
``{"ok": true, "device": {...}}``. Exits non-zero, with no result line,
when CUDA is unavailable or the port's sources are not beside the script.
"""
from __future__ import annotations

import copy
import json
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

def serve_run(model, cfg, prompts, a3, decode_block, max_new, **knobs):
    from repro_torch.kernels.decode_attention import kernel as tk
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(model, cfg, slots=4, max_len=512, a3=a3,
                      decode_block=decode_block, **knobs)
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
# phase 5: the two-pass path through the ops entry
# ---------------------------------------------------------------------------

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
    xl_launches = phase_xlstm_serve(dev)
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
    sys.exit(main())
