"""Train a language model on the synthetic pipeline with checkpoint/resume,
with the PyTorch port on ``--device`` (``cuda`` by default).

The port of ``examples/train_lm.py``. The default preset is small;
``--arch smollm-360m --full`` trains the real 360M config on the card.
Ctrl-C (or SIGTERM) mid-run checkpoints at the next step boundary; the
same command again resumes from the last checkpoint, and on the CPU the
resumed run equals an uninterrupted one bit for bit.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 20 --device cpu
"""

import argparse
import os
import tempfile

from repro_torch.config import TrainConfig, get_config, reduced_config
from repro_torch.train.trainer import Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cuda or cpu)")
    ap.add_argument("--full", action="store_true",
                    help="use the full config (needs a card)")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced_config(cfg, num_layers=4, d_model=128, head_dim=32,
                             d_ff=256 if cfg.d_ff else 0)
    tc = TrainConfig(
        total_steps=args.steps, warmup_steps=max(args.steps // 10, 1),
        checkpoint_every=10, checkpoint_dir=args.ckpt, learning_rate=1e-3,
    )
    tr = Trainer(cfg, tc, global_batch=args.batch, seq_len=args.seq,
                 device=args.device)
    start = tr.init_or_resume(resume=True)
    print(f"training {cfg.name} from step {start} "
          f"({cfg.num_params() / 1e6:.1f}M params) on {args.device}")
    out = tr.run(args.steps - start)
    losses = out["losses"]
    if losses:
        print(f"steps {start}..{out['final_step']}: "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if tr.watchdog.flagged:
        print("straggler steps:", tr.watchdog.flagged)


if __name__ == "__main__":
    main()
