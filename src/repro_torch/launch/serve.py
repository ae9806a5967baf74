"""Serving launcher of the port: random weights from ``--seed``, batched
requests through the slot engine, optionally with A^3.

  python -m repro_torch.launch.serve --arch phi4-mini-3.8b --a3 off
  python -m repro_torch.launch.serve --arch phi4-mini-3.8b --smoke \\
      --device cpu --requests 3 --max-new 4
  python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
      --decode-block 4 --pipeline-depth 1 --temperature 0.8
  python -m repro_torch.launch.serve --arch gemma3-4b --a3 conservative \\
      --max-len 2048 --prompt-len 1536
  python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
      --cache-pages 320 --page-size 64 --kv-quant int8
  python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
      --cache-pages 24 --l2-bytes 4294967296 --checkpoint-dir ckpt
  python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
      --checkpoint-dir ckpt --restore --chaos-rate 0.1 --chaos-seed 3
  python -m repro_torch.launch.serve --arch phi4-mini-3.8b --a3 \\
      conservative --telemetry --telemetry-every 8 --stats-json stats.json \\
      --metrics-json metrics.json --trace-out trace.json

``--arch`` takes every arch the port registers (``list_archs``).

Runs on the card unless ``--device cpu`` is given; prints the same
summary line as ``repro.launch.serve``; ``--stats-json`` writes its
``a3-serve-stats/v2`` snapshot (the port's knobs under ``config``).
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import A3Config, ServeConfig, get_arch, \
    list_archs, smoke_variant
from repro_torch.models import decoder
from repro_torch.serve.chaos import ChaosConfig, ChaosInjector
from repro_torch.serve.engine import ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="admission-prefill chunk in tokens; 0 = default "
                         "chunk of min(max_len, 512)")
    ap.add_argument("--prefill-chunk-min", type=int, default=0,
                    help="adaptive admission chunking floor: ticks with "
                         ">= 1 decoding slot shrink the chunk to this "
                         "many tokens; 0 = fixed chunk")
    ap.add_argument("--page-size", type=int, default=64,
                    help="prefix-cache page in tokens (the trie's edge "
                         "length)")
    ap.add_argument("--cache-pages", type=int, default=0,
                    help="paged prefix-cache budget in pages of "
                         "--page-size tokens (shared prompt prefixes are "
                         "restored by one gather a tick instead of "
                         "prefilled again); 0 = disabled")
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8"],
                    help="prefix-cache pool precision: int8 stores K/V "
                         "pages (and A^3 sorted-key snapshots) with "
                         "float32 scales, dequantized in the warm gather; "
                         "none = the serving dtype")
    ap.add_argument("--l2-bytes", type=int, default=0,
                    help="host-RAM L2 page-store budget in bytes: prefix-"
                         "cache evictions demote pages (K/V, int8 scales, "
                         "mixer snapshots, A^3 sorted keys) to checksummed "
                         "host blobs instead of freeing them, and later "
                         "lookups promote verified blobs back to the pool; "
                         "0 = disabled (evictions free)")
    ap.add_argument("--checkpoint-dir", default="",
                    help="write a crash-consistent engine checkpoint "
                         "(slots, queue, device cache, prefix trie and L2 "
                         "tier) to this directory after the run; empty = "
                         "no checkpoint")
    ap.add_argument("--restore", action="store_true",
                    help="restore the engine from --checkpoint-dir before "
                         "serving (in-flight requests continue token for "
                         "token); the directory must hold a checkpoint")
    ap.add_argument("--decode-block", type=int, default=1,
                    help="decode steps per dispatch (the host reads the "
                         "token ring once per block)")
    ap.add_argument("--pipeline-depth", type=int, default=0,
                    help="decode-block harvests left in flight behind the "
                         "tick loop (the next block's tokens ride the "
                         "device-resident carry); 0 = synchronous harvest")
    ap.add_argument("--stats-json", default="",
                    help="write a versioned engine-stats snapshot (schema "
                         "tag, config echo, counters, and the metrics "
                         "registry when telemetry is on) as JSON to this "
                         "path after the run; empty = none")
    ap.add_argument("--telemetry", action="store_true",
                    help="the serving telemetry plane: metrics registry "
                         "(TTFT / TPOT / queue-sojourn histograms), "
                         "request tracing, and the A^3 quality probe "
                         "(candidate count and captured score mass, every "
                         "--telemetry-every decode dispatches); adds no "
                         "host sync, tokens unchanged")
    ap.add_argument("--telemetry-every", type=int, default=8,
                    help="run the A^3 quality probe on every N-th decode "
                         "dispatch")
    ap.add_argument("--metrics-json", default="",
                    help="write the metrics-registry snapshot as JSON to "
                         "this path after the run; implies --telemetry")
    ap.add_argument("--trace-out", default="",
                    help="write the request-lifecycle trace as "
                         "Chrome-trace JSON (chrome://tracing, Perfetto) "
                         "to this path after the run; implies --telemetry")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature, keyed by --seed, request "
                         "uid and position; 0 = greedy argmax")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="most queued requests (overload beyond it is "
                         "shed per --shed-policy); 0 = unbounded")
    ap.add_argument("--shed-policy", default="reject-new",
                    choices=["reject-new", "evict-oldest-queued"],
                    help="which request a full queue sheds (it ends "
                         "REJECTED; submit never raises for overload)")
    ap.add_argument("--deadline-ticks", type=int, default=0,
                    help="per-request deadline in engine ticks (requests "
                         "not finished in time end EXPIRED); 0 = none")
    ap.add_argument("--retain-results", type=int, default=0,
                    help="keep at most this many terminal requests' "
                         "status/result (results pop on first read); "
                         "0 = unbounded")
    ap.add_argument("--chaos-rate", type=float, default=0.0,
                    help="chaos injection: per-site per-tick fault "
                         "probability (corrupt a decoding lane, fail a "
                         "page gather, abort a tick mid-phase); 0 = off")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed of the deterministic chaos schedule (a run "
                         "is reproducible from (seed, rate))")
    ap.add_argument("--a3", default="off",
                    choices=["off", "conservative", "aggressive"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    a3 = {"off": A3Config(), "conservative": A3Config.conservative(),
          "aggressive": A3Config.aggressive()}[args.a3]
    telemetry = bool(args.telemetry or args.metrics_json or args.trace_out)
    serve = ServeConfig(slots=args.slots, max_len=args.max_len,
                        prefill_chunk=args.prefill_chunk or None,
                        prefill_chunk_min=args.prefill_chunk_min or None,
                        decode_block=args.decode_block,
                        pipeline_depth=args.pipeline_depth,
                        temperature=args.temperature,
                        sample_seed=args.seed,
                        page_size=args.page_size,
                        cache_pages=args.cache_pages,
                        kv_quant=args.kv_quant,
                        l2_bytes=args.l2_bytes,
                        max_queue=args.max_queue,
                        shed_policy=args.shed_policy,
                        deadline_ticks=args.deadline_ticks or None,
                        telemetry=telemetry,
                        telemetry_every=args.telemetry_every,
                        retain_results=args.retain_results)
    chaos = None
    if args.chaos_rate > 0.0:
        chaos = ChaosInjector(ChaosConfig(seed=args.chaos_seed,
                                          rate=args.chaos_rate))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = decoder.init_params(cfg, gen, device)
    if args.restore:
        if not args.checkpoint_dir:
            ap.error("--restore requires --checkpoint-dir")
        engine = ServeEngine.restore(args.checkpoint_dir, model, cfg, a3=a3,
                                     chaos=chaos)
        print(f"restored engine from {args.checkpoint_dir} "
              f"(in_flight={engine.in_flight})")
    else:
        engine = ServeEngine.from_config(model, cfg, serve, a3=a3,
                                         chaos=chaos)

    rng = np.random.default_rng(args.seed)
    uids = [engine.submit(
        rng.integers(0, cfg.vocab_size, size=args.prompt_len),
        max_new_tokens=args.max_new) for _ in range(args.requests)]

    t0 = time.time()
    engine.run_to_completion()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    # one read per request: with --retain-results a read pops the result
    results = [engine.result(u) for u in uids]
    done = sum(1 for r in results if r is not None)
    total_new = sum(len(r or []) for r in results)
    by_status = collections.Counter(engine.status(u) for u in uids)
    print(f"arch={cfg.name} a3={args.a3} requests={done}/{len(uids)} "
          f"new_tokens={total_new} ({total_new / dt:.1f} tok/s, "
          f"{dt:.1f}s) statuses={dict(by_status)} stats={engine.stats}")
    if chaos is not None:
        print(f"chaos: seed={args.chaos_seed} rate={args.chaos_rate} "
              f"events={chaos.events} victims={sorted(chaos.injected_uids)}")
    if args.stats_json:
        snapshot = {
            "schema": "a3-serve-stats/v2",
            "config": {"arch": cfg.name, "a3": args.a3,
                       "smoke": bool(args.smoke),
                       "requests": args.requests,
                       "prompt_len": args.prompt_len,
                       "max_new": args.max_new, "seed": args.seed,
                       "serve": dataclasses.asdict(serve)},
            "stats": dict(engine.stats),
        }
        if engine.tm is not None:
            snapshot["metrics"] = engine.tm.metrics_snapshot()
        with open(args.stats_json, "w") as f:
            json.dump(snapshot, f, indent=2, sort_keys=True)
        print(f"wrote engine stats to {args.stats_json}")
    if args.metrics_json and engine.tm is not None:
        engine.tm.write_metrics(args.metrics_json)
        print(f"wrote metrics snapshot to {args.metrics_json}")
    if args.trace_out and engine.tm is not None:
        engine.tm.write_trace(args.trace_out)
        print(f"wrote chrome trace to {args.trace_out}")
    if args.checkpoint_dir:
        engine.checkpoint(args.checkpoint_dir)
        print(f"checkpointed engine to {args.checkpoint_dir}")


if __name__ == "__main__":
    main()
