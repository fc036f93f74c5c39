"""Mixed deployments of the two-party runtime: a JAX package endpoint and
a port endpoint complete a session together, in both roles, with revealed
outputs equal to the port's in-process session and per-tag wire ledgers
equal to its metered oracle on both endpoints (the frames are the same
bytes in both packages); and the port's pipelined
``NetPrivateServeEngine``, whose bundle refill streams on its own endpoint
pair while requests are served on the other. Everything runs on the CPU
at D=8 and a 16-bit share modulus; the JAX side garbles through its host
oracle. Tolerance 0: outputs and byte counts are exact."""

import threading

import numpy as np
import pytest

from repro.config import PrivacyConfig as JConfig
from repro.core.engine import PrivateTransformer as JModel
from repro.core.engine import random_weights
from repro.net import GarblerEndpoint as JGarbler
from repro.net import InProcPipe as JPipe
from repro.net import PitNetServer as JServer
from repro_torch.config import PrivacyConfig as TConfig
from repro_torch.core.engine import PrivateTransformer as TModel
from repro_torch.core.engine import weights_from_reference
from repro_torch.net import GarblerEndpoint, InProcPipe, PitNetServer
from repro_torch.serve import (
    BundlePoolEmpty,
    NetPrivateServeEngine,
    PrivateRequest,
)

D, HEADS, DFF, S = 8, 2, 16, 4
PCFG = dict(he_poly_n=64, he_num_primes=2, he_t_bits=16, frac_bits=5)


def _models(seed):
    ws = random_weights(np.random.default_rng(seed), D, DFF, 1)
    jm = JModel(JConfig(**PCFG), D, HEADS, DFF, ws, seed=seed)
    tm = TModel(TConfig(**PCFG), D, HEADS, DFF, weights_from_reference(ws),
                seed=seed, device="cpu")
    return jm, tm


@pytest.mark.parametrize("garbler", ["jax", "port"])
@pytest.mark.parametrize("wire", [1, 2])
def test_mixed_endpoints_complete_a_session(garbler, wire):
    jm, tm = _models(seed=31)
    x = np.random.default_rng(32).normal(0, 1, (S, D))
    a, b = (JPipe if garbler == "port" else InProcPipe).make_pair()
    if garbler == "jax":
        srv = PitNetServer(tm, S, device="cpu")
        srv.serve_transport(b, timeout=300)
        cli = JGarbler(a, seed=33, impl="ref", timeout=300,
                       wire_version=wire)
    else:
        srv = JServer(jm, S, impl="ref")
        srv.serve_transport(b, timeout=300)
        cli = GarblerEndpoint(a, seed=33, device="cpu", timeout=300,
                              wire_version=wire)
    cli.preprocess(1)
    y = cli.run(x)
    assert cli.shared.negotiated_version == wire
    sess = tm.compile_session(S, wire_version=wire, device="cpu")
    assert np.array_equal(y, sess.run(x, sess.preprocess(1)[0]))
    st = sess.stats
    for led in (cli.shared.ledger, srv.shared.ledger):
        assert led.offline.by_tag == dict(st.channel_offline.by_tag)
        assert led.online.by_tag == dict(st.channel_online.by_tag)
    cli.close()


def test_pipelined_refill_overlaps_serving():
    _, tm = _models(seed=8)
    rng = np.random.default_rng(9)
    srv = PitNetServer(tm, S, device="cpu")
    off_c, off_s = InProcPipe.make_pair()
    on_c, on_s = InProcPipe.make_pair()
    srv.serve_transport(off_s, timeout=300, name="pit-eval-offline")
    srv.serve_transport(on_s, timeout=300, name="pit-eval-online")
    eng = NetPrivateServeEngine(off_c, on_c, pool_target=2, seed=13,
                                device="cpu", timeout=300)
    eng.preprocess(1)
    assert eng.pool_size() == 1

    # hold back offline *responses* until serving is done: refill traffic
    # is in flight on its own endpoint pair the whole time
    gate = threading.Event()
    off_c.recv_gate = gate
    refill = eng.refill_async(1)
    req = PrivateRequest(x=rng.normal(0, 1, (S, D)))
    eng.serve([req])
    assert req.result is not None
    assert refill.is_alive(), "refill should still be streaming"
    gate.set()
    refill.join(timeout=300)
    assert eng.pool_size() == 1
    sess = tm.compile_session(S, wire_version=2, device="cpu")
    assert np.array_equal(req.result, sess.run(req.x, sess.preprocess(1)[0]))

    eng.serve([PrivateRequest(x=rng.normal(0, 1, (S, D)))])
    with pytest.raises(BundlePoolEmpty):
        eng.serve([PrivateRequest(x=rng.normal(0, 1, (S, D)))])
    assert eng.maintain() == 2
    # a bad request must not burn the bundle it claimed
    with pytest.raises(ValueError):
        eng.serve([PrivateRequest(x=rng.normal(0, 1, (S, D + 1)))])
    assert eng.pool_size() == 2
    eng.close()
