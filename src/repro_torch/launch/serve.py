"""Serving launcher of the port: random weights from ``--seed``, batched
requests through the slot engine, optionally with A^3.

  python -m repro_torch.launch.serve --arch phi4-mini-3.8b --a3 off
  python -m repro_torch.launch.serve --arch phi4-mini-3.8b --smoke \\
      --device cpu --requests 3 --max-new 4
  python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
      --decode-block 4 --pipeline-depth 1 --temperature 0.8
  python -m repro_torch.launch.serve --arch gemma3-4b --a3 conservative \\
      --max-len 2048 --prompt-len 1536

``--arch`` takes every arch the port registers (``list_archs``).

Runs on the card unless ``--device cpu`` is given; prints the same
summary line as ``repro.launch.serve``.
"""
from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import A3Config, ServeConfig, get_arch, \
    list_archs, smoke_variant
from repro_torch.models import decoder
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
    ap.add_argument("--decode-block", type=int, default=1,
                    help="decode steps per dispatch (the host reads the "
                         "token ring once per block)")
    ap.add_argument("--pipeline-depth", type=int, default=0,
                    help="decode-block harvests left in flight behind the "
                         "tick loop (the next block's tokens ride the "
                         "device-resident carry); 0 = synchronous harvest")
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
    serve = ServeConfig(slots=args.slots, max_len=args.max_len,
                        prefill_chunk=args.prefill_chunk or None,
                        prefill_chunk_min=args.prefill_chunk_min or None,
                        decode_block=args.decode_block,
                        pipeline_depth=args.pipeline_depth,
                        temperature=args.temperature,
                        sample_seed=args.seed,
                        max_queue=args.max_queue,
                        shed_policy=args.shed_policy,
                        deadline_ticks=args.deadline_ticks or None,
                        retain_results=args.retain_results)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = decoder.init_params(cfg, gen, device)
    engine = ServeEngine.from_config(model, cfg, serve, a3=a3)

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


if __name__ == "__main__":
    main()
