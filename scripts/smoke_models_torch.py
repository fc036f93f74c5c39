"""Quick one-device smoke of every reduced architecture on the PyTorch
port: a forward pass, a train step, a prefill and a decode step, each
finite and of the right shape. The counterpart of
``scripts/smoke_models.py``, on ``repro_torch``.

    PYTHONPATH=src python scripts/smoke_models_torch.py [--device cuda] \\
        [--arch llama3.2-1b --arch olmoe-1b-7b ...]

``--device`` defaults to ``cuda`` and raises when no card is there; pass
``cpu`` to run on the CPU. ``--arch`` may repeat to pick a subset (all 11
by default). Exits 1 if any architecture fails.
"""

import argparse
import math
import sys
import time
import traceback

ARCHS = [
    "olmoe-1b-7b", "llama4-scout-17b-a16e", "llama3.2-1b", "deepseek-67b",
    "qwen3-1.7b", "smollm-360m", "musicgen-medium", "xlstm-125m",
    "zamba2-2.7b", "internvl2-26b", "bert-base-pit",
]
B, S = 2, 64


def make_batch(cfg, kind, rng, dev):
    import torch

    def floats(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype("float32")).to(dev)

    def ints(*shape):
        return torch.from_numpy(
            rng.integers(0, cfg.vocab_size, shape)).to(dev)

    s = 1 if kind == "decode" else S
    out = {}
    if cfg.input_mode == "embeddings":
        out["embeddings"] = floats(B, s, cfg.d_model)
    elif cfg.input_mode == "tokens+image" and kind != "decode":
        n = cfg.num_image_tokens
        out["tokens"] = ints(B, S - n)
        out["image_embeds"] = floats(B, n, cfg.d_model)
    else:
        out["tokens"] = ints(B, s)
    if kind == "train":
        out["labels"] = ints(B, S)
    return out


def smoke(arch, dev, rng):
    import torch

    from repro_torch.config import TrainConfig, get_config, reduced_config
    from repro_torch.launch.steps import (build_decode_step,
                                          build_prefill_step,
                                          build_train_step)
    from repro_torch.models.transformer import forward, init_caches, \
        init_params
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.utils.tree import tree_map

    cfg = reduced_config(get_config(arch))
    params = init_params(cfg, torch.Generator(dev).manual_seed(0))
    # forward
    hidden, aux = forward(cfg, params, make_batch(cfg, "train", rng, dev),
                          mode="train")
    assert hidden.shape == (B, S, cfg.d_model), hidden.shape
    assert torch.isfinite(hidden).all() and torch.isfinite(aux).all(), \
        "forward not finite"
    # train step (it updates the state's tensors in place: a copy)
    step, _, _, _ = build_train_step(cfg, TrainConfig(microbatches=1))
    copy = tree_map(torch.clone, params)
    state = {"params": copy, "opt": init_opt_state(copy),
             "step": torch.tensor(0, dtype=torch.int32, device=dev)}
    state2, metrics = step(state, make_batch(cfg, "train", rng, dev))
    loss = float(metrics["loss"])
    assert math.isfinite(loss), f"loss not finite: {loss}"
    assert int(state2["step"]) == 1
    if cfg.causal:
        prefill, _, _, _ = build_prefill_step(cfg)
        decode, _, _, _ = build_decode_step(cfg)
        logits, _ = prefill(params, make_batch(cfg, "prefill", rng, dev))
        assert logits.shape == (B, cfg.padded_vocab), logits.shape
        assert torch.isfinite(logits).all(), "prefill logits not finite"
        caches = init_caches(cfg, B, S + 4, dtype=getattr(torch, cfg.dtype),
                             device=dev)
        logits2, _ = decode(params, make_batch(cfg, "decode", rng, dev),
                            caches)
        assert logits2.shape == (B, cfg.padded_vocab), logits2.shape
        assert torch.isfinite(logits2).all(), "decode logits not finite"
    return loss


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on")
    ap.add_argument("--arch", action="append", choices=ARCHS, default=None,
                    help="an architecture to smoke (repeat; default all)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device; pass "
                           f"--device cpu to run on the CPU")
    rng = np.random.default_rng(0)
    failures = []
    for arch in args.arch or ARCHS:
        t0 = time.perf_counter()
        try:
            loss = smoke(arch, args.device, rng)
            print(f"PASS {arch:26s} loss={loss:.4f} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
        except Exception as e:
            traceback.print_exc()
            print(f"FAIL {arch}: {e}", flush=True)
            failures.append(arch)
    if failures:
        print("FAILURES:", failures)
        return 1
    print("all smoke passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
