"""A numpy emulation of the float32 numerics of B2 and B3 on the tensor
cores (csrc/flash_attention.cu, the `bf16x3` variants), against float64.

Each fp32 operand is split into three bf16 pieces (8 + 8 + 8 significant
bits, rounded to nearest even, their sum exact), and every product of the
kernels (S = Q·Kᵀ and O += P·V in the forward; Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ,
dV += Pᵀ·dO, dK += dSᵀ·Q and dQ += dS·K in the backward) sums six
piece products, smallest first (a3·b1, a1·b3, a2·b2, a2·b1, a1·b2, a1·b1),
into one fp32 accumulator a k-step of 16 at a time. The products are exact;
each k-step's sum is added to the accumulator with one rounding, here
toward zero (the tensor core's fp32 adds truncate). Truncation is biased,
so a tile's terms sum in a fresh accumulator that is then added to the
running O, dV or dK in fp32, rounded to nearest: into one accumulator over
a long key or query axis the bias outgrows the tolerance (as the card
showed for B2's o at M = 4096). The softmax
is B2's and B3's own: tiles of 64 keys, the accurate exp2 in fp32, the
forward's rescale only when the row maximum moves. The second split,
3×TF32 (two pieces of 11 significant bits, three products, k-steps of 8),
is what the design did not take. Its scores are about twice as far from
float64 (an fp32 dot product's accuracy), yet every output stays within
tolerance here too: numerics alone would admit it. The layouts decide:
TF32 wgmma reads only K-major operands, and four of B3's five products
read an MN-major one, which bf16 wgmma takes through the descriptor's
transpose bit.
"""

import numpy as np
import pytest

f32, f64 = np.float32, np.float64
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
TILE = 64
# chip_smoke.py: B2_TOL["float32"] (o, relative to max |v|), B2_LSE_TOL and
# B3_TOL["float32"] (each gradient, relative to its max |·|)
B2_TOL, B2_LSE_TOL, B3_TOL = 1e-5, 1e-4, 1e-4
SHAPES = [(256, 256, 16, 128), (256, 200, 32, 256), (128, 130, 64, 512)]  # N, M, dk, dv


def _round_bits(x, drop):
    """fp32 x rounded to nearest even, keeping all but the `drop` low mantissa bits."""
    b = np.ascontiguousarray(x, dtype=f32).view(np.uint32).astype(np.uint64)
    half = (np.uint64(1) << np.uint64(drop - 1)) - np.uint64(1)
    b = (b + half + ((b >> np.uint64(drop)) & np.uint64(1))) & ~((np.uint64(1) << np.uint64(drop))
                                                                - np.uint64(1))
    return b.astype(np.uint32).view(f32)


def split(x, kind):
    """The pieces of fp32 x: three bf16 (bf16x3) or two TF32 (tf32x2)."""
    drop, n = (16, 3) if kind == "bf16x3" else (13, 2)
    pieces, rest = [], x.astype(f32)
    for _ in range(n):
        pieces.append(_round_bits(rest, drop))
        rest = (rest - pieces[-1]).astype(f32)  # exact
    return pieces


SPLITS = {  # (piece pairs in the kernel's order, smallest first; k-step)
    "bf16x3": (((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0)), 16),
    "tf32x2": (((1, 0), (0, 1), (0, 0)), 8),
}


def _add_rz(acc, part):
    """fp32(acc + part), rounded toward zero."""
    s = acc.astype(f64) + part
    r = s.astype(f32)
    over = np.abs(r.astype(f64)) > np.abs(s)
    r[over] = np.nextafter(r[over], f32(0))
    return r


def mm(a, b, kind, acc=None):
    """a [m, K] · b [K, n] (fp32 arrays) as the kernel forms it: the pieces'
    products, each over every k-step, into one fp32 accumulator."""
    pairs, kstep = SPLITS[kind]
    ap, bp = split(a, kind), split(b, kind)
    out = np.zeros((a.shape[0], b.shape[1]), f32) if acc is None else acc
    for i, j in pairs:
        for k0 in range(0, a.shape[1], kstep):
            part = ap[i][:, k0:k0 + kstep].astype(f64) @ bp[j][k0:k0 + kstep].astype(f64)
            out = _add_rz(out, part)
    return out


def exp2(x):
    return np.exp2(x.astype(f64)).astype(f32)  # the accurate exp2f: within an ulp


def fma(a, b, c):
    return (a.astype(f64) * f64(b) + c.astype(f64)).astype(f32)


def forward(q, k, v, scale, kind, fresh=True):
    """B2: (o, lse) of one batch row, key tiles of 64 with the online
    softmax. `fresh`: each tile's P·V sums in a fresh accumulator, added to
    O in fp32 a tile later, as (O + tile)·alpha (the kernel's order);
    else every tile's products go into O itself."""
    n, m = q.shape[0], k.shape[0]
    c = f32(scale * LOG2E)
    mx = np.full(n, -np.inf, f32)
    l = np.zeros(n, f32)
    acc = np.zeros((n, v.shape[1]), f32)
    pending = np.zeros_like(acc)
    for t in range(0, m, TILE):
        s = mm(q, k[t:t + TILE].T, kind)
        new = np.maximum(mx, s.max(1))
        sc = (new * c).astype(f32)
        moved = new != mx
        alpha = np.ones(n, f32)
        alpha[moved] = exp2(fma(mx[moved], c, -sc[moved]))
        p = exp2(fma(s, c, -sc[:, None]))
        l = (l * alpha + p.sum(1, dtype=f32)).astype(f32)
        if fresh:
            acc = ((acc + pending) * alpha[:, None]).astype(f32)
            pending = mm(p, v[t:t + TILE], kind)
        else:
            acc = mm(p, v[t:t + TILE], kind, (acc * alpha[:, None]).astype(f32))
        mx = new
    o = ((acc + pending) / l[:, None]).astype(f32)
    lse = ((mx * c + np.log2(l.astype(f64))) * LN2).astype(f32)
    return o, lse


def backward(q, k, v, o, lse, do, scale, kind):
    """B3: (dq, dk, dv) of one batch row from the forward's fp32 o and lse,
    a key tile (64 keys) against every q tile (64 rows) in turn."""
    n, m = q.shape[0], k.shape[0]
    c = f32(scale * LOG2E)
    l2 = (lse * f32(LOG2E)).astype(f32)
    d = (do * o).sum(1, dtype=f32)
    dq = np.zeros(q.shape, f32)
    dk = np.zeros(k.shape, f32)
    dv = np.zeros(v.shape, f32)
    for t in range(0, m, TILE):
        kt, vt = k[t:t + TILE], v[t:t + TILE]
        dk_acc = np.zeros(kt.shape, f32)
        dv_acc = np.zeros(vt.shape, f32)
        for r in range(0, n, TILE):
            qr, dor = q[r:r + TILE], do[r:r + TILE]
            pt = exp2(fma(mm(kt, qr.T, kind), c, -l2[None, r:r + TILE]))
            dv_acc = (dv_acc + mm(pt, dor, kind)).astype(f32)  # a fresh accumulator a q tile
            dpt = mm(vt, dor.T, kind)
            dst = (pt * (dpt - d[None, r:r + TILE]).astype(f32)).astype(f32)
            dk_acc = (dk_acc + mm(dst, qr, kind)).astype(f32)
            dq[r:r + TILE] += (mm(dst.T, kt, kind) * f32(scale)).astype(f32)
        dk[t:t + TILE] = dk_acc * f32(scale)
        dv[t:t + TILE] = dv_acc
    return dq, dk, dv


def reference(q, k, v, do, scale):
    """(o, lse, dq, dk, dv) in float64."""
    q, k, v, do = (x.astype(f64) for x in (q, k, v, do))
    s = q @ k.T * scale
    mx = s.max(1, keepdims=True)
    lse = mx[:, 0] + np.log(np.exp(s - mx).sum(1))
    p = np.exp(s - lse[:, None])
    o = p @ v
    ds = p * (do @ v.T - (do * o).sum(1, keepdims=True))
    return o, lse, ds @ k * scale, ds.T @ q * scale, p.T @ do


def inputs(n, m, dk, dv, seed=0):
    """chip_smoke.py's distribution: q, k with standard deviation 3, v and
    do with 1."""
    rng = np.random.default_rng(seed + n + m + dk + dv)
    q = (3 * rng.standard_normal((n, dk))).astype(f32)
    k = (3 * rng.standard_normal((m, dk))).astype(f32)
    v = rng.standard_normal((m, dv)).astype(f32)
    do = rng.standard_normal((n, dv)).astype(f32)
    return q, k, v, do, 1.0 / dv ** 0.5


def errors(shape, kind):
    """Each output's error against float64, relative as chip_smoke.py
    holds it."""
    q, k, v, do, scale = inputs(*shape)
    want_o, want_lse, *want_grads = reference(q, k, v, do, scale)
    o, lse = forward(q, k, v, scale, kind)
    grads = backward(q, k, v, o, lse, do, scale, kind)
    err = {"o": float(np.abs(o - want_o).max() / np.abs(v).max()),
           "lse": float((np.abs(lse - want_lse) / np.maximum(np.abs(want_lse), 1.0)).max())}
    for name, got, want in zip(("dq", "dk", "dv"), grads, want_grads):
        err[name] = float(np.abs(got - want).max() / np.abs(want).max())
    return err


def test_split_is_exact():
    x = np.random.default_rng(1).standard_normal(100_000).astype(f32) * f32(3e4)
    # exact down to |x| ~ 2^-110: the low piece's bits must stay above
    # bf16's least subnormal, 2^-133
    x[:4] = [0.0, f32(1e-30), f32(-3e38), f32(2 ** -100)]
    hi, mid, lo = split(x, "bf16x3")
    assert np.array_equal(hi.astype(f64) + mid + lo, x.astype(f64))
    # two TF32 pieces keep 21-22 of fp32's 24 bits
    t1, t2 = split(x, "tf32x2")
    assert (np.abs(t1.astype(f64) + t2 - x) <= np.abs(x.astype(f64)) * 2.0 ** -21).all()
    for p in (hi, mid, lo):  # each piece is a bf16 value
        assert not (p.view(np.uint32) & 0xFFFF).any()
    big = np.abs(x) > 1e-30
    assert (np.abs(mid[big]) <= np.abs(hi[big]) * 2.0 ** -8).all()
    assert (np.abs(lo[big]) <= np.abs(hi[big]) * 2.0 ** -16).all()


TOL = {"o": B2_TOL, "lse": B2_LSE_TOL, "dq": B3_TOL, "dk": B3_TOL, "dv": B3_TOL}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bf16x3_numerics(shape):
    """The design's products keep every output well inside its tolerance
    (under a third of it, with the adds rounded toward zero)."""
    err = errors(shape, "bf16x3")
    assert all(err[name] <= 0.3 * TOL[name] for name in TOL), err


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tf32x2_numerics(shape):
    """3×TF32 on the same inputs: its scores lose about a bit against the
    three bf16 pieces, and its outputs stay within tolerance as well; what
    rules it out is the operand layout (module note)."""
    q, k, _, _, _ = inputs(*shape)
    want = q.astype(f64) @ k.astype(f64).T
    s_err = {kind: float(np.abs(mm(q, k.T, kind) - want).max()) for kind in SPLITS}
    assert s_err["tf32x2"] >= 1.5 * s_err["bf16x3"], s_err
    err = errors(shape, "tf32x2")
    assert all(err[name] <= 0.3 * TOL[name] for name in TOL), err


def test_fresh_accumulator_a_tile():
    """At M = 4096 (64 key tiles) every P·V product summed into O itself
    drifts past B2's tolerance, as on the card; a fresh accumulator a
    tile, added to O in fp32, keeps o well inside it."""
    q, k, v, do, scale = inputs(64, 4096, 32, 64)
    want = reference(q, k, v, do, scale)[0]
    err = {fresh: float(np.abs(forward(q, k, v, scale, "bf16x3", fresh)[0] - want).max()
                        / np.abs(v).max()) for fresh in (True, False)}
    assert err[True] <= 0.3 * B2_TOL and err[False] > B2_TOL, err
