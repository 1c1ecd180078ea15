"""3xTF32 against one TF32 pass, emulated in numpy: the product of the
float32 conv and DCN kernels (`csrc/common.cuh`: `split_tf32`,
`mma_tf32x3_row`) on the qocc checkpoint's float32 weights.

- The split: hi = x rounded to TF32 (10 mantissa bits, to nearest, ties
  away from zero: the value of cvt.rna.tf32.f32, which the kernels compute
  by adding half a TF32 ulp to the bits and masking), lo = x - hi (exact in
  float32), which the tensor cores read truncated to its 19 high bits.
- An m16n8k8 step: each product of two TF32 values is exact in float32;
  the 8 products of a k-step are summed in float32 and added to the
  float32 accumulator. 3xTF32 adds the k-step's lo_a hi_b sum, then
  hi_a lo_b, then hi_a hi_b; one TF32 pass adds hi_a hi_b alone. (The
  tensor cores' own rounding of those sums is not modelled: the card tests
  and chip_smoke.py's float32 rows hold the kernels to it.)
- Each GEMM is an im2col of a small seeded input times the layer's weights,
  K = k * k * Cin in the packed order (column t * Cin + c): the 64->64
  feature conv, the 128->64 motion layer and a 64->27 offset conv on
  post-ReLU inputs, and the DCN's GEMM at R = 1 on seeded offsets (its slab
  the kernels' float32 bilinear samples times the mask).

3xTF32 stays within 2^-14 * max|float64| (the float32 kernel rows' limit)
at every one; one TF32 pass does not.
"""

import os

import numpy as np
import pytest

from vfi_tpu_torch.utils.convert import load_params_npz, params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QOCC = os.path.join(REPO, "artifacts", "emavfi_qocc_best.npz")
LIMIT = 2.0 ** -14
F32 = np.float32


def tf32_round(x: np.ndarray) -> np.ndarray:
    """x rounded to TF32, to nearest with ties away from zero: half a TF32
    ulp added to the bits, the 13 low bits masked (the kernels' hi)."""
    bits = np.asarray(x, F32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def tf32_trunc(x: np.ndarray) -> np.ndarray:
    """The 19 high bits the tensor cores read of a TF32 operand."""
    return (np.asarray(x, F32).view(np.uint32)
            & np.uint32(0xFFFFE000)).view(F32)


def split(x: np.ndarray) -> tuple:
    hi = tf32_round(x)
    return hi, tf32_trunc((x - hi).astype(F32))


def mma_gemm(a: np.ndarray, b: np.ndarray, passes: int) -> np.ndarray:
    """a [M, K] @ b [K, N], K a multiple of 8, as the kernels' MMAs sum it:
    per k-step of 8, each pass's 8 exact products summed in float32, then
    added to the float32 accumulator; passes 3 (lo_a hi_b, hi_a lo_b,
    hi_a hi_b) or 1 (hi_a hi_b)."""
    (ah, al), (bh, bl) = split(a.astype(F32)), split(b.astype(F32))
    terms = [(al, bh), (ah, bl), (ah, bh)] if passes == 3 else [(ah, bh)]
    acc = np.zeros((a.shape[0], b.shape[1]), F32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in terms:
            prod = x[:, k0:k0 + 8, None] * y[None, k0:k0 + 8, :]
            s = prod[:, 0]
            for i in range(1, 8):
                s = (s + prod[:, i]).astype(F32)
            acc = (acc + s).astype(F32)
    return acc


@pytest.fixture(scope="module")
def sd():
    return {k: v.numpy() for k, v in
            params_from_jax(load_params_npz(QOCC)).items()}


def im2col(x: np.ndarray, k: int) -> np.ndarray:
    """(H, W, C) zero-padded by k // 2 -> [H * W][k * k * C], column
    t * C + c with t = k * i + j."""
    h, w, c = x.shape
    m = k // 2
    xp = np.pad(x, ((m, m), (m, m), (0, 0)))
    cols = [xp[i:i + h, j:j + w] for i in range(k) for j in range(k)]
    return np.concatenate(cols, axis=-1).reshape(h * w, k * k * c)


def packed(weight: np.ndarray) -> np.ndarray:
    """OIHW -> [K][Cout], row t * Cin + c (the float32 pack, transposed)."""
    cout, cin, kh, kw = weight.shape
    return weight.transpose(2, 3, 1, 0).reshape(kh * kw * cin, cout)


def bilinear_slab(x: np.ndarray, off: np.ndarray, mask: np.ndarray,
                  R: int) -> np.ndarray:
    """The DCN's slab [H * W][9 * C]: tap t of pixel (y, x) samples
    (y + t // 3 - 1 + dy, x + t % 3 - 1 + dx), offsets clamped to [-R, R],
    zeros outside, the float32 blend of the kernels (weights (wy * wx) *
    mask, corners (y0, x0), (y0, x1), (y1, x0), (y1, x1), no fused
    multiply-add)."""
    h, w, c = x.shape
    slab = np.zeros((h, w, 9, c), F32)

    def at(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = x[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(ok[..., None], v, F32(0))

    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    for t in range(9):
        dy = np.clip(off[..., 2 * t], -R, R).astype(F32)
        dx = np.clip(off[..., 2 * t + 1], -R, R).astype(F32)
        fy = (ys + t // 3 - 1).astype(F32) + dy
        fx = (xs + t % 3 - 1).astype(F32) + dx
        y0, x0 = np.floor(fy), np.floor(fx)
        wy, wx = (fy - y0).astype(F32), (fx - x0).astype(F32)
        y0, x0 = y0.astype(int), x0.astype(int)
        m = mask[..., t]
        ws = [((F32(1) - wy) * (F32(1) - wx)) * m,
              ((F32(1) - wy) * wx) * m, (wy * (F32(1) - wx)) * m,
              (wy * wx) * m]
        corners = [at(y0, x0), at(y0, x0 + 1), at(y0 + 1, x0),
                   at(y0 + 1, x0 + 1)]
        acc = ws[0].astype(F32)[..., None] * corners[0]
        for wt, v in zip(ws[1:], corners[1:]):
            acc = (acc + wt.astype(F32)[..., None] * v).astype(F32)
        slab[:, :, t] = acc
    return slab.reshape(h * w, 9 * c)


def gemm_case(name: str, sd: dict) -> tuple:
    """(a, b) of one layer's GEMM at 6 x 10 pixels, seeded."""
    rng = np.random.default_rng(20)
    if name == "dcn":
        wt = sd["fusion_dcn0.weight"]
        x = rng.standard_normal((6, 10, 64)).astype(F32)
        off = rng.uniform(-1.5, 1.5, (6, 10, 18)).astype(F32)
        mask = (1 / (1 + np.exp(-rng.standard_normal((6, 10, 9))))).astype(
            F32)
        return bilinear_slab(x, off, mask, 1), packed(wt)
    wt = sd[{"feat": "feat_ext_block0.conv.weight",
             "motion": "motion_conv1.conv.weight",
             "offset": "fusion_dcn0.offset_conv.weight"}[name]]
    x = np.maximum(rng.standard_normal((6, 10, wt.shape[1])), 0).astype(F32)
    return im2col(x, wt.shape[-1]), packed(wt)


CASES = ["feat", "motion", "offset", "dcn"]


def rel_err(name: str, sd: dict, passes: int) -> float:
    a, b = gemm_case(name, sd)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    got = mma_gemm(a, b, passes)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("name", CASES)
def test_tf32x3_is_within_the_float32_rows_limit(name, sd):
    """K = 576 (feat, offset, the DCN) and 1152 (motion): 3xTF32 within
    2^-14 of max|float64|, with room (the kernels' float32 rows share that
    limit with the tensor cores' own rounding)."""
    assert rel_err(name, sd, 3) <= LIMIT / 8


@pytest.mark.parametrize("name", CASES)
def test_one_tf32_pass_is_not(name, sd):
    """hi_a hi_b alone keeps 11 bits of each operand: past 2^-14."""
    assert rel_err(name, sd, 1) > LIMIT


def test_the_hi_split_is_round_to_nearest_ties_away():
    """The add-and-mask equals rounding the significand to 11 bits, ties
    away from zero, on ties, carries into the exponent and both signs; lo
    = x - hi is exact."""
    def reference(x):
        m, e = np.frexp(np.float64(x))            # x = m * 2^e, |m| in [0.5, 1)
        q = np.sign(m) * np.floor(np.abs(m) * 2 ** 11 + 0.5)
        return F32(np.ldexp(q / 2 ** 11, e))

    rng = np.random.default_rng(3)
    one = np.uint32(F32(1.0).view(np.uint32))
    ties = np.array([one + 0x1000, one + 0x3000, one + 0x0FFF,
                     one + 0x7FFFFF], np.uint32).view(F32)
    xs = np.concatenate([ties, -ties, rng.standard_normal(2000).astype(F32),
                         (rng.standard_normal(200) * 1e-30).astype(F32)])
    for x in xs:
        assert tf32_round(np.array([x]))[0] == reference(x), x
    hi = tf32_round(xs)
    assert np.array_equal(hi.astype(np.float64) + (xs - hi).astype(np.float64),
                          xs.astype(np.float64))
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()


def test_a_tensor_core_reads_lo_within_2_pow_minus_21():
    """lo truncated to TF32 (what the tensor cores read of it) loses under
    2^-21 of |x| beside hi: far below the 2^-14 limit."""
    x = np.random.default_rng(4).standard_normal(5000).astype(F32)
    hi, lo = split(x)
    err = np.abs(hi.astype(np.float64) + lo - x.astype(np.float64))
    assert (err <= 2.0 ** -21 * np.abs(x)).all()
