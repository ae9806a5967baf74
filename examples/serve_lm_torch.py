"""Serving example of the PyTorch port: batched requests through the
slot engine with the A^3 approximate decode path, comparing exact vs
approximate outputs and reporting agreement + engine stats. The port's
counterpart of ``examples/serve_lm.py``, with the same arguments and
printout; on the card unless ``--device cpu`` is given.

Every ``engine.step()`` is one *tick* of the admission state machine::

    admit -> chunked prefill -> blocked decode
                                 (T x [resort -> step -> sample])

* **admit**: queued requests claim free slots and enter the PREFILLING
  phase (no forward pass; the first chunk dispatch resets the slot's
  reused mixer state — KV ring rows and recurrent carries).
* **chunked prefill**: all PREFILLING slots advance by up to
  ``prefill_chunk`` prompt tokens in one padded ragged dispatch (per-
  slot cursors), so a long prompt never stalls decoding slots for more
  than one chunk. A slot whose cursor reaches the end of its prompt
  samples its first token on the device and flips to DECODING.
* **blocked decode**: every DECODING slot advances up to
  ``decode_block`` = T tokens in one dispatch (per-slot positions, the
  KV cache updated in place). Sampling runs on the device (greedy
  argmax), each step feeding the next, and the A^3 ``sorted_upto``
  watermark check + fresh-tail re-sort run in the same dispatch; the
  host syncs once per block to harvest the [slots, T] token ring
  (``stats["host_syncs"]``). Lanes that exhaust their budget mid-block
  ride along masked at pos=-1.

Chunking and decode blocking are scheduling decisions, not model
changes — the example runs the same prompts with whole-prompt,
chunked, and blocked-decode engines, reports that the generations are
identical (up to fp-tie flips), then compares exact vs A^3. The weights
are random (the arch's smoke variant, drawn from seed 0).

    PYTHONPATH=src python examples/serve_lm_torch.py [--arch phi4-mini-3.8b] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import A3Config, get_arch, smoke_variant
from repro_torch.models import decoder
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--decode-block", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = smoke_variant(get_arch(args.arch))
    model = decoder.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=args.prompt_len)
               for _ in range(args.requests)]

    results = {}
    runs = [("exact", A3Config(), None, 1),
            ("exact-chunked", A3Config(), args.prefill_chunk, 1),
            ("exact-blocked", A3Config(), args.prefill_chunk,
             args.decode_block),
            ("a3-conservative", A3Config.conservative(), None, 1)]
    syncs = {}
    for label, a3, chunk, block in runs:
        eng = ServeEngine(model, cfg, slots=4, max_len=256, a3=a3,
                          prefill_chunk=chunk, decode_block=block)
        uids = [eng.submit(p, max_new_tokens=args.max_new) for p in prompts]
        eng.run_to_completion()
        results[label] = [eng.result(u) for u in uids]
        total = sum(len(r) for r in results[label])
        syncs[label] = eng.stats["host_syncs"] / max(total, 1)
        print(f"{label:16s}: {total} tokens generated, stats={eng.stats}")

    if results["exact"] == results["exact-chunked"]:
        print("\nchunked admission == whole-prompt admission "
              "(scheduling changed, outputs did not)")
    else:
        print("\nWARNING: chunked admission changed outputs "
              "(fp-tie flip or recurrent-arch fallback)")
    if results["exact"] == results["exact-blocked"]:
        print(f"blocked decode (T={args.decode_block}) == per-step decode "
              f"at {syncs['exact-blocked']:.2f} host syncs/token "
              f"(vs {syncs['exact']:.2f} per-step)")
    else:
        print("\nWARNING: blocked decode changed outputs (fp-tie flip)")

    agree = np.mean([
        np.mean(np.asarray(a) == np.asarray(b))
        for a, b in zip(results["exact"], results["a3-conservative"])])
    print(f"\nexact vs A3-conservative token agreement: {agree:.2%}")
    print("sample exact      :", results["exact"][0])
    print("sample a3-conserv :", results["a3-conservative"][0])


if __name__ == "__main__":
    main()
