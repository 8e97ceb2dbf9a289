"""Farnebäck dense optical flow (torch port of ld_decode_tpu/comb/optflow.py).

The NTSC comb's default 3D mode gates temporal chroma with Farnebäck flow
on each field's NR'd luma (reference comb-ntsc.cxx:600-662).  The math is
the JAX package's (OpenCV's FarnebackPolyExp / FarnebackUpdateMatrices /
FarnebackUpdateFlow_Blur), with a leading batch dimension on every op: the
comb runs both fields of a frame in one call.

* polynomial expansion: separable correlations with replicate borders,
  each one matmul of an unfolded window against the taps;
* per iteration: the bilinear warp of the quad-expanded second fields --
  one row gather over all fields through kernel K2 (ops/gather.py) --
  then the normal equations, a box blur and a closed-form 2x2 solve per
  pixel;
* pyramid levels resized with jax.image.resize's antialiased triangle
  filter, rebuilt here as separable weight matrices (`resize_weights`).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ld_decode_tpu_torch.ops.gather import take_along_axis
from ld_decode_tpu_torch.utils.device import constant
from ld_decode_tpu_torch.utils.device import resolve as resolve_device

# ---------------------------------------------------------------------------
# polynomial expansion


def _poly_exp_kernels(n: int, sigma: float):
    """Gaussian base kernels and the inverse-metric elements ig11/ig03/
    ig33/ig55 (OpenCV FarnebackPrepareGaussian)."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg = x * g
    xxg = x * x * g

    # metric G for basis (1, x, y, x^2, y^2, xy) under w(x,y)=g(x)g(y)
    s2 = float((g * x * x).sum())          # E[x^2]
    s4 = float((g * x ** 4).sum())         # E[x^4]
    G = np.zeros((6, 6))
    G[0, 0] = 1.0
    G[1, 1] = G[2, 2] = s2
    G[3, 3] = G[4, 4] = s4
    G[5, 5] = s2 * s2
    G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = s2
    G[3, 4] = G[4, 3] = s2 * s2
    Ginv = np.linalg.inv(G)
    return (g, xg, xxg, float(Ginv[1, 1]), float(Ginv[0, 3]),
            float(Ginv[3, 3]), float(Ginv[5, 5]))


def _sep_correlate(img: torch.Tensor, kerns, axis: int) -> torch.Tensor:
    """1-D correlations of (B, H, W) images along `axis` (0 = rows of the
    image, 1 = columns) with replicate borders (OpenCV's row buffers).
    `kerns` is one kernel or a list of equal-length kernels; with a list
    the result gets a trailing axis, one entry per kernel."""
    single = isinstance(kerns, np.ndarray)
    ks = np.stack([kerns] if single else list(kerns), axis=1)   # (K, nk)
    n = (ks.shape[0] - 1) // 2
    pad = (0, 0, n, n) if axis == 0 else (n, n, 0, 0)
    x = F.pad(img[:, None], pad, mode='replicate')[:, 0]
    win = x.unfold(1 + axis, ks.shape[0], 1)            # (B, H, W, K)
    out = win @ constant(ks, img.dtype, img.device)
    return out[..., 0] if single else out


def poly_expansion(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """Quadratic expansion coefficients per pixel of (B, H, W) images.

    Returns (B, H, W, 5) float32: [vy, vx, vxx, vyy, vxy] in OpenCV's R
    layout (drow[x*5+0..4])."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_exp_kernels(n, sigma)
    f = img.to(torch.float32)

    # vertical pass: correlate columns with g, xg, xxg
    t = _sep_correlate(f, [g, xg, xxg], 0)
    t0, t1, t2 = t[..., 0], t[..., 1], t[..., 2]

    # horizontal pass
    h0 = _sep_correlate(t0, [g, xg, xxg], 1)
    b1, b2, b4 = h0[..., 0], h0[..., 1], h0[..., 2]
    h1 = _sep_correlate(t1, [g, xg], 1)
    b3, b5 = h1[..., 0], h1[..., 1]
    b6 = _sep_correlate(t2, g, 1)

    by = b3 * ig11                    # linear y coefficient
    bx = b2 * ig11                    # linear x coefficient
    ayy = b1 * ig03 + b6 * ig33       # y^2 (vertical xxg path)
    axx = b1 * ig03 + b4 * ig33       # x^2 (horizontal xxg path)
    axy = b5 * ig55
    return torch.stack([by, bx, ayy, axx, axy], dim=-1)


# ---------------------------------------------------------------------------
# displacement update

_BORDER = 5


def _border_scale(h: int, w: int) -> np.ndarray:
    """OpenCV down-weights the outer BORDER=5 pixels of the matrix field
    (FarnebackUpdateMatrices border[] ramp)."""
    ramp = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472, 1.0])
    iy = np.minimum(np.minimum(np.arange(h), h - 1 - np.arange(h)), _BORDER)
    ix = np.minimum(np.minimum(np.arange(w), w - 1 - np.arange(w)), _BORDER)
    return (ramp[iy][:, None] * ramp[ix][None, :]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _border_scale_dev(h: int, w: int, device: str) -> torch.Tensor:
    """`_border_scale` on the device, copied once per level shape."""
    return torch.from_numpy(_border_scale(h, w)).to(device)


def _quad_expand(R: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H*W, 4*C) with the 4 bilinear-corner shifts
    precomputed: row p = [R[y,x], R[y,min(x+1,W-1)], R[min(y+1,H-1),x],
    R[min(y+1),min(x+1)]].  Built once per pyramid level and shared by
    all warp iterations."""
    b, h, w, c = R.shape
    Rx = torch.cat([R[:, :, 1:], R[:, :, -1:]], dim=2)
    Ry = torch.cat([R[:, 1:], R[:, -1:]], dim=1)
    Rxy = torch.cat([Ry[:, :, 1:], Ry[:, :, -1:]], dim=2)
    return torch.cat([R, Rx, Ry, Rxy], dim=-1).reshape(b, h * w, 4 * c)


def _bilinear_gather_quad(Rq: torch.Tensor, h: int, w: int, c: int,
                          fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """Sample the quad-expanded fields (B, H*W, 4*C) at float coords
    (B, H, W), clamped to the frame.  All four corners of a pixel come
    from one 4*C-wide row: one take_along_axis on axis 0 over the B*H*W
    rows of all fields, field b's rows offset by b*H*W, with the row index
    broadcast across the row (a stride-0 view) -- one launch of kernel K2
    on the card."""
    b = fx.shape[0]
    fx = torch.clamp(fx, 0.0, w - 1.001)
    fy = torch.clamp(fy, 0.0, h - 1.001)
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    ax = (fx - x0)[..., None]
    ay = (fy - y0)[..., None]
    base = torch.arange(b, dtype=torch.int32, device=fx.device) * (h * w)
    rows = ((y0 * w + x0).reshape(b, h * w) + base[:, None]).reshape(-1, 1)
    q = take_along_axis(Rq.reshape(b * h * w, 4 * c),
                        rows.expand(b * h * w, 4 * c),
                        0).reshape(b, h, w, 4, c)
    return (q[..., 0, :] * (1 - ay) * (1 - ax) + q[..., 1, :] * (1 - ay) * ax
            + q[..., 2, :] * ay * (1 - ax) + q[..., 3, :] * ay * ax)


def _update_matrices(R0: torch.Tensor, R1q: torch.Tensor, flow: torch.Tensor,
                     bscale: torch.Tensor) -> torch.Tensor:
    """Per-pixel normal-equation entries [g11, g12, g22, h1, h2]
    (OpenCV FarnebackUpdateMatrices).  R0 (B, H, W, 5); R1q the
    quad-expanded second fields (`_quad_expand(R1)`); flow (B, H, W, 2)."""
    h, w = R0.shape[1:3]
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=R0.device),
        torch.arange(w, dtype=torch.float32, device=R0.device),
        indexing='ij')
    dx = flow[..., 0]
    dy = flow[..., 1]
    fx = xx + dx
    fy = yy + dy
    x1 = torch.floor(fx)
    y1 = torch.floor(fy)
    inside = ((x1 >= 0) & (x1 < w - 1) & (y1 >= 0) & (y1 < h - 1))
    r1 = _bilinear_gather_quad(R1q, h, w, 5, fx, fy)

    # averaged quadratic terms (cv2's r4/r5/r6): outside the warp range
    # the sampled side is dropped and the cross term halved
    r4 = torch.where(inside, (R0[..., 2] + r1[..., 2]) * 0.5, R0[..., 2])
    r5 = torch.where(inside, (R0[..., 3] + r1[..., 3]) * 0.5, R0[..., 3])
    r6 = torch.where(inside, (R0[..., 4] + r1[..., 4]) * 0.25,
                     R0[..., 4] * 0.5)
    z = torch.zeros_like(r4)
    r2 = (R0[..., 0] - torch.where(inside, r1[..., 0], z)) * 0.5  # Δb_y
    r3 = (R0[..., 1] - torch.where(inside, r1[..., 1], z)) * 0.5  # Δb_x
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx

    r2 = r2 * bscale
    r3 = r3 * bscale
    r4 = r4 * bscale
    r5 = r5 * bscale
    r6 = r6 * bscale

    g11 = r4 * r4 + r6 * r6
    g12 = (r4 + r5) * r6
    g22 = r5 * r5 + r6 * r6
    h1 = r4 * r2 + r6 * r3
    h2 = r6 * r2 + r5 * r3
    return torch.stack([g11, g12, g22, h1, h2], dim=-1)


def _box_blur(M: torch.Tensor, winsize: int) -> torch.Tensor:
    """Box filter of (B, H, W, C): the sum over 2*(winsize//2)+1 taps per
    axis with replicate borders, divided by winsize**2 as OpenCV's
    FarnebackUpdateFlow_Blur does.  The running sums are float64 (cast
    back once), so their rounding does not grow along a ~900-wide row."""
    m = winsize // 2

    def blur_axis(x, axis):
        n = x.shape[axis]
        idx = torch.arange(-(m + 1), n + m, device=x.device).clamp(0, n - 1)
        c = torch.cumsum(x.index_select(axis, idx), dim=axis)
        return c.narrow(axis, 2 * m + 1, n) - c.narrow(axis, 0, n)

    out = blur_axis(blur_axis(M.to(torch.float64), 1), 2)
    return out.to(torch.float32) * (1.0 / (winsize * winsize))


def _solve_flow(Mb: torch.Tensor) -> torch.Tensor:
    g11, g12, g22, h1, h2 = (Mb[..., i] for i in range(5))
    det = g11 * g22 - g12 * g12
    det = torch.where(det.abs() < 1e-9, 1e-9, det)
    fx = (g11 * h2 - g12 * h1) / det
    fy = (g22 * h1 - g12 * h2) / det
    return torch.stack([fx, fy], dim=-1)


# ---------------------------------------------------------------------------
# pyramid driver

def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of jax.image.resize(...,
    'linear') along one axis (jax/_src/image/scale.py compute_weight_mat,
    antialias=True): a triangle kernel widened by 1/scale when
    downsampling, columns renormalised, in float32 as JAX computes it."""
    f32 = np.float32
    scale = f32(out_size / in_size)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.0) * inv_scale - f32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]
               ) / kernel_scale
    weights = np.maximum(f32(0), f32(1) - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0)).astype(f32)


@functools.lru_cache(maxsize=None)
def _resize_matrix(in_size: int, out_size: int, device: str) -> torch.Tensor:
    return torch.from_numpy(resize_weights(in_size, out_size)).to(device)


def resize_linear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """jax.image.resize(x, (h, w[, C]), 'linear') of (B, H, W) or
    (B, H, W, C): two float32 matrix products with the separable weights
    (TF32 is off package-wide)."""
    chan = x.dim() == 4
    if chan:
        x = x.permute(0, 3, 1, 2)                    # (B, C, H, W)
    dev = str(x.device)
    H, W = x.shape[-2:]
    if W != w:
        x = x @ _resize_matrix(W, w, dev)
    if H != h:
        x = _resize_matrix(H, h, dev).T @ x
    return x.permute(0, 2, 3, 1) if chan else x


def _gauss_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    ksz = max(int(round(sigma * 5)) | 1, 3)
    n = ksz // 2
    x = np.arange(-n, n + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    k /= k.sum()
    return _sep_correlate(_sep_correlate(img, k, 0), k, 1)


def farneback(img0: torch.Tensor, img1: torch.Tensor,
              flow0: Optional[torch.Tensor], pyr_scale: float, levels: int,
              winsize: int, iterations: int, poly_n: int, poly_sigma: float,
              use_init: bool) -> torch.Tensor:
    """Farnebäck flow of img0 -> img1 for (B, H, W) image pairs (the JAX
    package's `_farneback_jit`, with a batch dimension).  flow0 (B, H, W,
    2) is the initial flow when use_init.  Returns (B, H, W, 2) float32
    displacements in x, y order."""
    _, h, w = img0.shape
    f0 = img0.to(torch.float32)
    f1 = img1.to(torch.float32)

    flow = None
    for k in range(levels, -1, -1):
        scale = float(pyr_scale) ** k
        hk = int(round(h * scale))
        wk = int(round(w * scale))

        if flow is None:
            if use_init:
                flow = resize_linear(flow0.to(torch.float32), hk, wk) * scale
            else:
                flow = torch.zeros((img0.shape[0], hk, wk, 2),
                                   dtype=torch.float32, device=img0.device)
        else:
            flow = resize_linear(flow, hk, wk) * (1.0 / float(pyr_scale))

        if k == 0:
            i0, i1 = f0, f1
        else:
            sigma = (1.0 / scale - 1.0) * 0.5
            i0 = resize_linear(_gauss_blur(f0, sigma), hk, wk)
            i1 = resize_linear(_gauss_blur(f1, sigma), hk, wk)

        R0 = poly_expansion(i0, poly_n, poly_sigma)
        R1q = _quad_expand(poly_expansion(i1, poly_n, poly_sigma))
        bscale = _border_scale_dev(hk, wk, str(img0.device))

        M = _update_matrices(R0, R1q, flow, bscale)
        for it in range(iterations):
            flow = _solve_flow(_box_blur(M, winsize))
            if it < iterations - 1:
                M = _update_matrices(R0, R1q, flow, bscale)
    return flow


def calc_optical_flow_farneback(
        prev_img, next_img, flow=None, pyr_scale: float = 0.5,
        levels: int = 4, winsize: int = 60, iterations: int = 3,
        poly_n: int = 7, poly_sigma: float = 1.5,
        use_initial_flow: bool = False, device='cuda') -> torch.Tensor:
    """cv2.calcOpticalFlowFarneback's interface over (H, W) or (B, H, W)
    images (numpy or tensors): the (..., H, W, 2) float32 displacement of
    prev -> next in x, y order, on `device`."""
    device = resolve_device(device)
    prev = torch.as_tensor(np.asarray(prev_img) if not isinstance(
        prev_img, torch.Tensor) else prev_img, device=device)
    nxt = torch.as_tensor(np.asarray(next_img) if not isinstance(
        next_img, torch.Tensor) else next_img, device=device)
    single = prev.dim() == 2
    if single:
        prev, nxt = prev[None], nxt[None]
    h, w = prev.shape[1:]
    # OpenCV caps the pyramid so every level keeps both dims >= 32 px
    # (calcOpticalFlowFarneback min_size)
    k, scale = 0, 1.0
    while k < levels:
        scale *= pyr_scale
        if h * scale < 32 or w * scale < 32:
            break
        k += 1
    use_init = flow is not None and use_initial_flow
    flow0 = None
    if use_init:
        flow0 = torch.as_tensor(np.asarray(flow) if not isinstance(
            flow, torch.Tensor) else flow, dtype=torch.float32,
            device=device)
        if single:
            flow0 = flow0[None]
    out = farneback(prev.to(torch.float32), nxt.to(torch.float32), flow0,
                    float(pyr_scale), int(k), int(winsize), int(iterations),
                    int(poly_n), float(poly_sigma), use_init)
    return out[0] if single else out
