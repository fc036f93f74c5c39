"""The port's configuration plane and data pipeline against the JAX
package's: the same registry, every ``ModelConfig`` field for field, the
same reduced configs, parameter counts and shape cells, and bit-equal
synthetic batches."""

import dataclasses
import logging

import numpy as np
import pytest

import repro.config as JC
from repro.data.pipeline import ByteTokenizer as JTokenizer
from repro.data.pipeline import SyntheticLMData as JData
import repro_torch.config as TC
from repro_torch.data import ByteTokenizer, SyntheticLMData
from repro_torch.utils import get_logger

ARCHS = sorted(JC.list_configs())


def test_registry_lists_the_reference_names():
    assert TC.list_configs() == ARCHS
    assert len(ARCHS) == 11


def _derived(pkg, cfg):
    """What each package computes from a config."""
    return dict(padded_vocab=cfg.padded_vocab, num_params=cfg.num_params(),
                uses_attention=cfg.uses_attention,
                subquadratic=cfg.subquadratic, q_per_kv=cfg.q_per_kv,
                shapes=[dataclasses.asdict(s)
                        for s in pkg.assigned_shapes(cfg)])


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    j, t = JC.get_config(arch), TC.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert _derived(TC, t) == _derived(JC, j)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_config_equals_reference(arch):
    for over in ({}, {"num_layers": 2, "attn_chunk": 16}):
        j = JC.reduced_config(JC.get_config(arch), **over)
        t = TC.reduced_config(TC.get_config(arch), **over)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert _derived(TC, t) == _derived(JC, j)


def test_records_and_shapes_equal_reference():
    assert [dataclasses.asdict(s) for s in TC.SHAPES] == \
        [dataclasses.asdict(s) for s in JC.SHAPES]
    for name in ("MeshConfig", "TrainConfig", "PrivacyConfig"):
        j, t = getattr(JC, name)(), getattr(TC, name)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
    m = TC.MeshConfig(shape=(2, 4, 4), axes=("pod", "data", "model"))
    assert (m.num_devices, m.data_axes, m.model_axis) == \
        (32, ("pod", "data"), "model")


def test_bert_base_widths_match_the_registered_config():
    cfg, b = TC.get_config("bert-base-pit"), TC.BERT_BASE
    assert (b.name, b.num_layers, b.d_model, b.num_heads, b.head_dim,
            b.d_ff, b.vocab_size, b.activation) == \
        (cfg.name, cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.head_dim,
         cfg.d_ff, cfg.vocab_size, cfg.activation)


def test_register_refuses_a_conflicting_config():
    cfg = TC.get_config("llama3.2-1b")
    assert TC.register_config(cfg) is cfg
    with pytest.raises(ValueError):
        TC.register_config(dataclasses.replace(cfg, d_ff=1))
    with pytest.raises(KeyError):
        TC.get_config("no-such-model")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "musicgen-medium",
                                  "internvl2-26b"])
def test_synthetic_batches_bit_equal(arch):
    for hosts, index in ((1, 0), (2, 1)):
        kw = dict(global_batch=4, seq_len=24, seed=3, host_index=index,
                  num_hosts=hosts)
        jd = JData(JC.reduced_config(JC.get_config(arch)), **kw)
        td = SyntheticLMData(TC.reduced_config(TC.get_config(arch)), **kw)
        for step in (0, 5):
            jb, tb = jd.batch_at(step), td.batch_at(step)
            assert sorted(tb) == sorted(jb)
            for k in jb:
                assert tb[k].dtype == jb[k].dtype, k
                assert np.array_equal(tb[k], jb[k]), k
    first = next(iter(td))
    assert all(np.array_equal(first[k], td.batch_at(0)[k]) for k in first)


def test_byte_tokenizer_round_trips():
    text = "private inference — ünïcode ✓"
    tok, ref = ByteTokenizer(), JTokenizer()
    ids = tok.encode(text)
    assert np.array_equal(ids, ref.encode(text))
    assert tok.decode(ids) == text
    specials = np.concatenate([[tok.BOS], ids, [tok.EOS, tok.PAD]])
    assert tok.decode(specials) == ref.decode(specials) == text
    assert tok.vocab_size == ref.vocab_size == 259


def test_logger_is_the_port_s_own():
    log = get_logger("repro_torch.models")
    assert isinstance(log, logging.Logger)
    assert logging.getLogger("repro_torch").handlers
