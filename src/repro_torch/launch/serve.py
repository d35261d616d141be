"""Serving launcher: continuous-batching server over any architecture of
the zoo.

    python -m repro_torch.launch.serve --arch yi-6b --requests 8
    python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --requests 8
    python -m repro_torch.launch.serve --arch whisper-small --smoke --device cpu

Copied from ``repro.launch.serve`` for one card: random parameters from
seed 0 (the reference's fixed key, by the family's init rule),
``--requests`` prompts of 4-15 random tokens, decoded by a
``ContinuousBatcher`` (which prefills tokens only, as the reference's does:
no vision embeds or frames).  Runs on CUDA unless ``--device cpu`` is
given (raising without a card).  Prints the device, then the reference's
``served ... tok/s`` line (wall clock, after a device synchronise).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.base import get_config
from ..kernels._common import resolve_device
from ..models.registry import Model
from ..serve import batching


@torch.no_grad()
def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = Model(cfg)
    rng = np.random.default_rng(0)
    params = model.init_params(0, device=dev)
    cb = batching.ContinuousBatcher(model, params, n_slots=args.slots,
                                    max_len=args.max_len, device=dev)
    t0 = time.time()
    for rid in range(args.requests):
        prompt = rng.integers(
            0, cfg.vocab, (int(rng.integers(4, 16)),)).astype(np.int32)
        cb.submit(batching.Request(rid=rid, prompt=prompt,
                                   max_new_tokens=args.max_new))
    done = cb.run_to_completion()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    total = sum(len(r.out) for r in done.values())
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    print(f"served {len(done)}/{args.requests} requests, {total} tokens, "
          f"{total/dt:.1f} tok/s")


if __name__ == "__main__":
    main()
