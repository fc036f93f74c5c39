"""Plain NumPy reference of the private path's garbled-circuit functions.

Each function works out, word by word, what one garbled op of APINT's
protocol reveals: the client's and the server's shares mod ``t`` are
added inside the circuit, centred to a signed ``k``-bit word
(``k = bits(t) + 2``) and shifted right by the op's extra scale; the
function runs in ``k``-bit two's-complement fixed point with ``frac``
fractional bits; the result is re-masked with the client's share.

The arithmetic follows the circuits' published recipe (APINT §3.2 and
its i-BERT exp, Newton-Raphson reciprocal and rsqrt with a leading-one
normalisation, XFBQ multiplies, the 16-segment GeLU table and the
LayerNorm offload of Fig. 4), written as integer operations on whole
words, so it shares no code with the program: no netlist, no gate.
Every word is a ``uint64`` holding a ``k``-bit (or wider) pattern.

``reveal_*`` return the value the two shares reveal, ``(c + s) mod t``,
given the inputs' two shares and the client's output share ``c`` (the
mask, which is uniform and any value of which is a valid run; it enters
the result only through the re-masking's wrap, see ``_remask``).
"""

from __future__ import annotations

import math

import numpy as np

U64 = np.uint64
LN2 = math.log(2.0)


def word_bits(t: int) -> int:
    """Width of a circuit word for the prime ``t``."""
    return int(t).bit_length() + 2


def _mask(k: int) -> np.uint64:
    return U64((1 << k) - 1)


def _fx(value: float, frac: int, k: int) -> int:
    """A real constant in ``k``-bit fixed point (round half to even)."""
    return int(round(value * (1 << frac))) % (1 << k)


def _u(x) -> np.ndarray:
    return np.asarray(x, dtype=U64)


def _add(a, b, k):
    return (_u(a) + _u(b)) & _mask(k)


def _sub(a, b, k):
    return (_u(a) - _u(b)) & _mask(k)


def _msb(a, k):
    return ((_u(a) >> U64(k - 1)) & U64(1)).astype(bool)


def _sext(a, k, kw):
    """Sign-extend a ``k``-bit word to ``kw`` bits."""
    a = _u(a)
    if kw <= k:
        return a & _mask(kw)
    return np.where(_msb(a, k), a | (_mask(kw) ^ _mask(k)), a)


def _asr(a, n, k):
    """Arithmetic shift right by a constant, within ``k`` bits."""
    a = _u(a)
    neg = _msb(a, k)
    if n >= k:
        return np.where(neg, _mask(k), U64(0))
    fill = _mask(k) ^ _mask(k - n)
    return np.where(neg, (a >> U64(n)) | fill, a >> U64(n))


def _shift(a, sh, k):
    """Per element: left by ``sh`` (>= 0) or logically right by ``-sh``,
    within ``k`` bits (bits shifted past either end are lost)."""
    a = _u(a)
    sh = np.asarray(sh, np.int64)
    left = np.clip(sh, 0, 63).astype(U64)
    right = np.clip(-sh, 0, 63).astype(U64)
    out = np.where(sh >= 0, (a << left) & _mask(k), a >> right)
    return np.where(np.abs(sh) >= k, U64(0), out)


def _mul_const(a, c, k):
    return (_u(a) * U64(c % (1 << k))) & _mask(k)


def _lt_signed(a, b, k):
    """The sign of ``a - b`` mod 2^k (the circuits' range-limited compare)."""
    return _msb(_sub(a, b, k), k)


def _fx_mul(a, b, frac, k):
    """XFBQ fixed-point multiply: both operands widened to ``k + frac + 1``
    bits, each read with its least significant bit set (the XFBQ digit
    encoding without the Q-error terms), the product taken mod 2^kw,
    shifted right by ``frac`` and cut to ``k`` bits."""
    kw = k + frac + 1
    aw = _sext(a, k, kw) | U64(1)
    bw = _sext(b, k, kw) | U64(1)
    p = (aw * bw) & _mask(kw)
    return _asr(p, frac, kw) & _mask(k)


def _bit_length(x, k):
    """Position of the leading one plus one (0 for 0), per element."""
    x = _u(x)
    out = np.zeros(x.shape, np.int64)
    for b in range(k):
        out = np.where((x >> U64(b)) != 0, b + 1, out)
    return out


# ---------------------------------------------------------------------------
# the nonlinear functions, on signed k-bit words at scale frac
# ---------------------------------------------------------------------------


def exp_neg(x, frac, k, max_shift_bits=5):
    """exp(x) for x <= 0: q = floor(-x / ln 2), r = x + q ln 2, the i-BERT
    polynomial 0.3585 (r + 1.353)^2 + 0.344, then a right shift by q
    (0 once q reaches 2^max_shift_bits)."""
    kw = k + frac + 2
    nxw = _sext(_sub(0, x, k), k, kw)
    z = _mul_const(nxw, _fx(1.0 / LN2, frac, kw), kw)
    q = _asr(z, 2 * frac, kw) & _mask(k)
    r = _add(x, _mul_const(q, _fx(LN2, frac, k), k), k)
    tt = _add(r, _fx(1.353, frac, k), k)
    p = _mul_const(_fx_mul(tt, tt, frac, k), _fx(0.3585, frac, k), k)
    p = _add(_asr(p, frac, k), _fx(0.344, frac, k), k)
    amount = q & _mask(max_shift_bits)
    high = ((q >> U64(max_shift_bits)) & _mask(k - 1 - max_shift_bits)) != 0
    return np.where(high, U64(0), p >> amount)


def reciprocal(x, frac, k, iters=3):
    """1/x for x > 0: normalise x into [0.5, 1) by its leading one, seed
    48/17 - 32/17 m, ``iters`` Newton steps y(2 - m y), denormalise."""
    pos = _bit_length(x, k) - 1
    sh = (frac - 1) - pos
    m = _shift(x, sh, k)
    y = _sub(_fx(48.0 / 17.0, frac, k),
             _asr(_mul_const(m, _fx(32.0 / 17.0, frac, k), k), frac, k), k)
    two = _fx(2.0, frac, k)
    for _ in range(iters):
        xy = _fx_mul(m, y, frac, k)
        y = _fx_mul(y, _sub(two, xy, k), frac, k)
    return np.where(pos < 0, U64(0), _shift(y, sh, k))


def rsqrt(x, frac, k, iters=3):
    """1/sqrt(x) for x > 0: normalise into [1, 4) by an even shift, seed
    1.12 - 0.17 m, ``iters`` Newton steps y(3 - m y^2)/2, denormalise by
    half the shift."""
    pos = _bit_length(x, k) - 1
    sh = frac - pos
    sh_even = np.where(sh % 2 == 0, sh, sh + 1)
    m = _shift(x, sh_even, k)
    y = _sub(_fx(1.12, frac, k),
             _asr(_mul_const(m, _fx(0.17, frac, k), k), frac, k), k)
    three = _fx(3.0, frac, k)
    for _ in range(iters):
        y2 = _fx_mul(y, y, frac, k)
        xy2 = _fx_mul(m, y2, frac, k)
        y = _asr(_fx_mul(y, _sub(three, xy2, k), frac, k), 1, k)
    return np.where(pos < 0, U64(0), _shift(y, sh_even // 2, k))


def softmax_rows(x, frac, k):
    """Row softmax of (rows, n) words: a running max from the left, exp of
    each difference, a running sum from the left, one reciprocal, one
    multiply per element."""
    x = _u(x)
    mx = x[:, 0]
    for j in range(1, x.shape[1]):
        w = x[:, j]
        mx = np.where(_lt_signed(mx, w, k), w, mx)
    es = exp_neg(_sub(x, mx[:, None], k), frac, k)
    s = es[:, 0]
    for j in range(1, x.shape[1]):
        s = _add(s, es[:, j], k)
    inv = reciprocal(s, frac, k)
    return _fx_mul(es, inv[:, None], frac, k)


def _gelu(v: float) -> float:
    return 0.5 * v * (1.0 + math.erf(v / math.sqrt(2.0)))


def gelu(x, frac, k, segments=16):
    """GeLU: clip to [-4, 4 - ulp], then the chord of GeLU over the
    segment of width 8/``segments`` that holds x."""
    lo = _fx(-4.0, frac, k)
    hi = _fx(4.0, frac, k) - 1
    x = _u(x)
    xc = np.where(_lt_signed(x, lo, k), U64(lo), x)
    xc = np.where(_lt_signed(hi, xc, k), U64(hi), xc)
    xs = _add(xc, _fx(4.0, frac, k), k)
    seg_bits = int(math.log2(segments))
    idx = ((xs >> U64(frac + 3 - seg_bits)) & _mask(seg_bits)).astype(np.int64)
    width = 8.0 / segments
    slopes, intercepts = [], []
    for s in range(segments):
        a = -4.0 + s * width
        ga, gb = _gelu(a), _gelu(a + width)
        m = (gb - ga) / width
        slopes.append(_fx(m, frac, k))
        intercepts.append(_fx(ga - m * a, frac, k))
    slope = np.asarray(slopes, U64)[idx]
    icpt = np.asarray(intercepts, U64)[idx]
    return _add(_fx_mul(xc, slope, frac, k), icpt, k)


# ---------------------------------------------------------------------------
# the share boundary
# ---------------------------------------------------------------------------


def _reconstruct(xc, xs, t, k, descale):
    """Shares mod t -> a signed k-bit word (values from t//2 up are
    negative), arithmetically shifted right by ``descale``."""
    tw = U64(t)
    v = _add(xc, xs, k)
    v = np.where(v >= tw, _sub(v, tw, k), v)
    v = np.where(v >= U64(t // 2), _sub(v, tw, k), v)
    return _asr(v, descale, k) if descale else v


def _remask(y, c, t, k):
    """The server's share of a signed word y given the client's share c:
    y mod t, plus (t - c) mod t, less t once if that reaches t, all in k
    bits."""
    tw = U64(t)
    y = _u(y)
    v = np.where(_msb(y, k), _add(y, tw, k), y)
    m = (tw - _u(c) % tw) % tw
    s = _add(v, m, k)
    return np.where(s >= tw, _sub(s, tw, k), s)


def _revealed(y, c, t, k):
    c = _u(c)
    return (c % U64(t) + _remask(y, c, t, k)) % U64(t)


def mulmod(a, b, t):
    """a * b mod t for residues below 2^43, in uint64 (b split in 20-bit
    halves so no partial product passes 2^63)."""
    if t >= 1 << 43:
        raise ValueError("mulmod needs t < 2^43")
    a, b, tw = _u(a) % U64(t), _u(b) % U64(t), U64(t)
    hi, lo = b >> U64(20), b & U64((1 << 20) - 1)
    return (((a * hi) % tw) * U64(1 << 20) + a * lo) % tw


def encode_fx(x, frac, t):
    """round(x 2^frac) mod t (half to even), as the client encodes."""
    v = np.round(np.asarray(x, np.float64) * (1 << frac)).astype(np.int64)
    return np.mod(v, t).astype(U64)


# ---------------------------------------------------------------------------
# what one op reveals
# ---------------------------------------------------------------------------


def reveal_trunc(xc, xs, c, *, t, frac, in_scale):
    """Exact truncation of an (elementwise) value at ``in_scale`` to frac."""
    k = word_bits(t)
    y = _reconstruct(xc, xs, t, k, in_scale - frac)
    return _revealed(y, c, t, k)


def reveal_softmax(xc, xs, c, *, t, frac, in_scale):
    """Softmax over each row of (rows, n) shares at ``in_scale``."""
    k = word_bits(t)
    x = _reconstruct(xc, xs, t, k, in_scale - frac)
    return _revealed(softmax_rows(x, frac, k), c, t, k)


def reveal_gelu(xc, xs, c, *, t, frac, in_scale):
    """GeLU of each element of shares at ``in_scale``."""
    k = word_bits(t)
    x = _reconstruct(xc, xs, t, k, in_scale - frac)
    return _revealed(gelu(x, frac, k), c, t, k)


def reveal_layernorm(xc, xs, c, gamma, beta, *, t, frac, in_scale):
    """APINT's LayerNorm offload (Fig. 4 steps 7-13) of (rows, n) shares
    at ``in_scale``: mean and centring on the shares, the variance by the
    inner-product identity and gamma times the centred value mod t
    outside the circuit; in it, rsqrt of the variance and one multiply
    per element; beta added to the server's share last."""
    k = word_bits(t)
    tw = U64(t)
    xc, xs = _u(xc), _u(xs)
    rows, n = xc.shape
    inv_n = int(round((1 << frac) / n))
    gq = encode_fx(gamma, frac, t)
    bq = encode_fx(beta, frac, t)
    x = (xc + xs) % tw
    mu = mulmod(U64(inv_n), x.sum(axis=1, dtype=U64) % tw, t)
    cx = (mulmod(x, U64(1 << frac), t) + (tw - mu)[:, None]) % tw
    var = mulmod(U64(inv_n), mulmod(cx, cx, t).sum(axis=1, dtype=U64) % tw, t)
    gx = mulmod(gq[None, :], cx, t)
    sc = in_scale + frac
    zero = np.zeros_like(gx)
    g_words = _reconstruct(gx, zero, t, k, 0)
    v_word = _reconstruct(var, np.zeros_like(var), t, k, 0)
    v_word = _add(_asr(v_word, 2 * sc, k), 1, k)
    rs = rsqrt(v_word, frac, k)
    y = _fx_mul(_asr(g_words, sc, k), rs[:, None], frac, k)
    c = _u(c)
    s = (_remask(y, c, t, k) + bq[None, :]) % tw
    return (c % tw + s) % tw
