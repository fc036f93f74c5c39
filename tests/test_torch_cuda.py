"""Card-only checks of the port: the CUDA kernels against their plain
PyTorch versions, and the GC executor on the card against the CPU, bit
for bit. Every test skips where there is no NVIDIA GPU.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import garble as G
from repro_torch.core.circuits import arith
from repro_torch.core.circuits.builder import CircuitBuilder
from repro_torch.kernels.level_eval import level_eval as LE
from repro_torch.kernels.level_eval import ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have "
                    "no CPU mode; their plain versions are tested on the "
                    "CPU in test_torch_level_eval.py)")
    return torch.device("cuda")


def _operands(G_, seed):
    gen = torch.Generator().manual_seed(seed)
    words = lambda *s: torch.randint(-(1 << 31), 1 << 31, s,  # noqa: E731
                                     dtype=torch.int32, generator=gen)
    ops = (torch.arange(G_, dtype=torch.int32) % 4)[
        torch.randperm(G_, generator=gen)]
    r = words(1, 4)
    r[:, 0] |= 1
    return ops, words(G_, 4), words(G_, 4), words(G_, 4), words(G_, 4), \
        r.expand(G_, 4).contiguous(), words(G_)


@pytest.mark.parametrize("g", [1, 3001, 65_536 + 7])
def test_kernels_match_plain_version(cuda, g):
    ops, a, b, tg, te, r, tw = _operands(g, seed=g)
    LE.reset_launches()
    d = [x.to(cuda) for x in (ops, a, b, tg, te, r, tw)]
    got = LE.eval_level(d[0], d[1], d[2], d[3], d[4], d[6])
    gg = LE.garble_level(d[0], d[1], d[2], d[5], d[6])
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref.eval_level(ops, a, b, tg, te, tw))
    for x, y in zip(gg, ref.garble_level(ops, a, b, r, tw)):
        assert torch.equal(x.cpu(), y)
    assert (LE.eval_level.launches, LE.garble_level.launches) == (1, 1)


def test_wrapper_rejects_misaligned_labels(cuda):
    ops, a, b, tg, te, _, tw = (x.to(cuda) for x in _operands(9, seed=1))
    flat = a.reshape(-1)[1:33].reshape(8, 4)  # 4-byte offset
    with pytest.raises(ValueError, match="aligned"):
        LE.eval_level(ops[:8], flat, b[:8], tg[:8], te[:8], tw[:8])


@pytest.mark.parametrize("instances", [1, 16])
def test_executor_on_card_matches_cpu(cuda, instances):
    cb = CircuitBuilder("cmp")
    x, y = cb.g_input_word(12), cb.e_input_word(12)
    lt = arith.lt_signed(cb, x, y)
    cb.output(arith.mux(cb, lt, x, y))
    cb.output(cb.INV(lt))
    net = cb.build()
    rng = np.random.default_rng(instances)
    gb = rng.integers(0, 2, (instances, len(net.garbler_inputs)))
    eb = rng.integers(0, 2, (instances, len(net.evaluator_inputs)))
    outs = []
    for dev in (cuda, "cpu"):
        gc = G.garble(net, torch.Generator().manual_seed(0), instances,
                      device=dev)
        labels = torch.cat([G.encode_inputs(gc, net.garbler_inputs, gb),
                            G.encode_inputs(gc, net.evaluator_inputs, eb)],
                           dim=1)
        wires = np.concatenate([net.garbler_inputs, net.evaluator_inputs])
        out = G.evaluate(net, gc.tables, (wires, labels))
        assert np.array_equal(G.decode_outputs(gc, out),
                              net.eval_plain(gb, eb))
        outs.append([t.cpu() for t in (gc.input_zero, gc.tables,
                                       gc.output_perm, out)])
    assert all(torch.equal(x, y) for x, y in zip(*outs))
