"""Training launcher (``repro.launch.train``'s port), on one card.

    python -m repro_torch.launch.train --arch yi-6b --smoke --steps 50
    python -m repro_torch.launch.train --arch yi-6b --smoke --device cpu

Wires together: config -> model -> train step -> counter-based data ->
resilient loop (async checkpoints, retry, straggler log).  The flags are
the reference's, plus ``--device`` (``cuda``, the default, raises without a
card; ``cpu`` runs the plain versions).  Parameters come from
``Model.init_params(seed, device)``.  Without ``--smoke`` the reference
builds its production mesh; one card has no mesh, so ``--multi-pod`` and a
run without ``--smoke`` raise until the multi-card slice (``ROADMAP.md``
A5), as does ``--compress-dcn``.  ``--ckpt-dir`` defaults to the
checkout's ``build/train_ckpt``.
"""
from __future__ import annotations

import argparse

import torch

from ..configs.base import get_config
from ..kernels._common import resolve_device
from ..models.registry import Model
from ..train import data as data_mod
from ..train import fault_tolerance as ft_mod
from ..train import train_step as ts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=ft_mod.DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--compress-dcn", default=None,
                    choices=[None, "bf16", "int8"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.multi_pod or not args.smoke:
        raise NotImplementedError(
            "the production mesh (--multi-pod, or a run without --smoke) "
            "needs the multi-card slice (ROADMAP.md A5); run with --smoke")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = Model(cfg)
    tcfg = ts.TrainConfig(learning_rate=args.lr,
                          compress_dcn=args.compress_dcn)
    params = model.init_params(tcfg.seed, device=dev)
    state = ts.make_train_state(model, params, tcfg)
    step_fn = ts.build_train_step(model, tcfg)

    dcfg = data_mod.DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                               global_batch=args.global_batch)

    def batches(step):
        toks = data_mod.batch_for_step(dcfg, step)
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros(
                (args.global_batch, cfg.n_frontend_tokens, cfg.frontend_dim),
                dtype=torch.float32, device=dev)
        if cfg.family == "vlm":
            batch["vision_embeds"] = torch.zeros(
                (args.global_batch, 8, cfg.frontend_dim),
                dtype=torch.float32, device=dev)
        return batch

    ftc = ft_mod.FTConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    losses = []

    def metrics_cb(step, metrics, dt):
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"{dt*1e3:.0f} ms", flush=True)

    loop = ft_mod.ResilientLoop(step_fn, state, ftc,
                                health_cb=lambda m: print(f"[ft] {m}"))
    loop.run(batches, args.steps, metrics_cb)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}")
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
