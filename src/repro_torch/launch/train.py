"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-27b \
      [--smoke] [--steps 200] [--ckpt-dir ckpts/run1] [--compress topk] \
      [--device cuda|cpu]

A port of ``repro/launch/train.py``. ``--smoke`` runs the reduced config
end to end; the full configs do not fit one card in f32 (slice 7d shards
them). The weights are drawn by ``init_tree`` from a CPU
``torch.Generator`` seeded 0, so ``--device cuda`` and ``--device cpu``
start from the same weights; the batches are ``LMPipeline``'s, the
reference's arrays. ``--ckpt-dir`` runs the steps under
``train.fault.Supervisor`` (``--fail-at`` injects failures), and a rerun
resumes from the newest checkpoint. ``--device`` defaults to the card
and exits naming ``--device cpu`` on a host without one.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import LMDataConfig, LMPipeline
from repro_torch.optim import adamw
from repro_torch.optim.grad_compress import CompressConfig
from repro_torch.train.fault import ChaosConfig, Supervisor
from repro_torch.train.train_lib import make_lm_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-27b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--compress", default="none",
                    choices=["none", "topk", "int8"])
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject WorkerFailure at these steps (chaos test)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[train] {e}")

    spec = get_arch(args.arch)
    assert spec.family == "lm", "train.py drives LM archs; see bc_run.py"
    cfg = spec.config(smoke=args.smoke)
    batch = args.batch or (8 if args.smoke else 256)
    seq = args.seq or (128 if args.smoke else 4096)

    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps),
                                total_steps=args.steps)
    comp = CompressConfig(kind=args.compress)
    init_fn, step_fn = make_lm_train_step(
        cfg, opt_cfg, comp if args.compress != "none" else None, device=dev)
    pipe = LMPipeline(LMDataConfig(vocab=cfg.vocab, batch=batch, seq=seq))

    def fresh():
        return init_fn(torch.Generator().manual_seed(0))

    print(f"[train] arch={cfg.name} params={cfg.n_params()/1e6:.1f}M "
          f"batch={batch} seq={seq}")

    losses = []

    def do_step(st, step):
        t0 = time.time()
        st, metrics = step_fn(st, pipe.batch(step))
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0:
            tput = batch * seq / (time.time() - t0)
            print(f"[train] step {step} loss {loss:.4f} "
                  f"tok/s {tput:,.0f}")
        return st

    if args.ckpt_dir:
        sup = Supervisor(args.ckpt_dir, save_every=args.save_every)
        chaos = ChaosConfig(fail_at_steps=tuple(args.fail_at)) \
            if args.fail_at else None
        # a function, not a state: the steps update their state in place
        sup.run(init_state=fresh, step_fn=do_step, n_steps=args.steps,
                chaos=chaos)
    else:
        state = fresh()
        for step in range(args.steps):
            state = do_step(state, step)

    print(f"[train] done: first loss {losses[0]:.4f} "
          f"last loss {losses[-1]:.4f}")
    assert losses[-1] < losses[0], "loss must decrease"
    return losses


if __name__ == "__main__":
    main()
