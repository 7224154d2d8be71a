"""The plain QMF codec that the benchmark holds the port against.

Written from the codec's description (arXiv:2408.12691, Sec. 3-4) and the
byte format of its container, with plain PyTorch, NumPy, SciPy's LAPACK and
`zlib`; it imports nothing of the program. One image batch at a time:

- `encode_factors`: full-range BT.601 YCbCr, 2x2 area chroma, reflect pad,
  8x8 patches, the SVD init (column Gram, `?syevd`, sqrt-balanced factors,
  the sign that clips less) and projected Gauss-Seidel BCD sweeps; returns
  the int8 factors per channel.
- `parse_stream`: the container (length-prefixed framing, JSON metadata,
  one zlib stream per factor column) back to metadata and int8 factors.
- `decode`: factors to `(B, 3, H, W)` uint8 pixels.

`precision="float32"` is the configuration's arithmetic: float32 values,
with the Gram, `X v` and the square roots formed in float64 and rounded once,
and the 3x3 color mix as the chain ``fma(c2, m2, fma(c1, m1, c0 * m0))``
(each step exact in float64, rounded to float32). `precision="bfloat16"` is
the same code one precision lower (bfloat16 values, float32 where float64
was), the control that the comparison must fail.
"""

from __future__ import annotations

import json
import math
import zlib

import numpy as np
import scipy.linalg
import torch

RGB_TO_YCBCR = ((0.299, 0.587, 0.114), (-0.168736, -0.331264, 0.5), (0.5, -0.418688, -0.081312))
YCBCR_TO_RGB = ((1.0, 0.0, 1.40200), (1.0, -0.344136, -0.714136), (1.0, 1.77200, 0.0))
OFFSET = (0.0, 128.0, 128.0)
EPS = 1e-16
# (value dtype, wide dtype) per precision
PRECISIONS = {"float32": (torch.float32, torch.float64), "bfloat16": (torch.bfloat16, torch.float32)}


def _dtypes(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; one of {tuple(PRECISIONS)}")
    return PRECISIONS[precision]


def _coef(value: float, dtype) -> float:
    return float(torch.tensor(value, dtype=dtype))


def _mix(m, x: torch.Tensor, precision: str) -> torch.Tensor:
    """`m @ x` over dim -3, per output channel as the chain above."""
    val, wide = _dtypes(precision)
    c = [x[..., j, :, :].to(val) for j in range(3)]
    rows = []
    for i in range(3):
        acc = c[0] * _coef(m[i][0], val)
        for j in (1, 2):
            acc = (c[j].to(wide) * _coef(m[i][j], val) + acc.to(wide)).to(val)
        rows.append(acc)
    return torch.stack(rows, dim=-3)


def _offset(x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(OFFSET, dtype=x.dtype, device=x.device).reshape(3, 1, 1)


def rgb_to_ycbcr(rgb: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    x = rgb.to(_dtypes(precision)[0])
    return _offset(x) + _mix(RGB_TO_YCBCR, x, precision)


def ycbcr_to_rgb(ycbcr: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    x = ycbcr.to(_dtypes(precision)[0])
    return _mix(YCBCR_TO_RGB, x - _offset(x), precision)


def _pool_axis(x: torch.Tensor, out: int, axis: int) -> torch.Tensor:
    """Area pool along `axis`: window [floor(i*n/out), ceil((i+1)*n/out)),
    its mean (a divisible size) or its taps times float32(1 / length)
    summed in tap order."""
    n = x.shape[axis]
    if n == out:
        return x
    if n % out == 0:
        k = n // out
        shape = x.shape[:axis] + (out, k) + x.shape[axis + 1:]
        return torch.mean(x.reshape(shape), dim=axis + 1)
    starts = np.floor(np.arange(out) * n / out).astype(np.int64)
    ends = np.ceil((np.arange(out) + 1) * n / out).astype(np.int64)
    lengths = ends - starts
    shape = [1] * x.ndim
    shape[axis] = out
    w = torch.from_numpy((1.0 / lengths).astype(np.float32)).to(x.dtype).to(x.device).reshape(shape)
    total = None
    for k in range(int(lengths.max())):
        idx = torch.from_numpy(np.minimum(starts + k, n - 1)).to(x.device)
        term = torch.index_select(x, axis, idx) * w
        live = torch.from_numpy(k < lengths).to(x.device).reshape(shape)
        total = term if total is None else torch.where(live, total + term, total)
    return total


def _reflect_pad(x: torch.Tensor, patch) -> torch.Tensor:
    for axis, p in ((x.ndim - 2, patch[0]), (x.ndim - 1, patch[1])):
        n = x.shape[axis]
        extra = (p - n % p) % p
        if extra:
            idx = np.pad(np.arange(n), (extra // 2, extra - extra // 2), mode="reflect")
            x = torch.index_select(x, axis, torch.from_numpy(idx).to(x.device))
    return x


def channel_sizes(size, scale=(0.5, 0.5)):
    h, w = size
    c = (int(math.floor(h * scale[0])), int(math.floor(w * scale[1])))
    return [tuple(size), c, c]


def padded(size, patch=(8, 8)):
    return [size[0] + (patch[0] - size[0] % patch[0]) % patch[0], size[1] + (patch[1] - size[1] % patch[1]) % patch[1]]


def ranks(size, quality: float, scale=(0.5, 0.5), patch=(8, 8)) -> list[int]:
    """R = max(round(min(M, N) * q / 100), 1) per channel, q halved for chroma."""
    out = []
    for ch, q in zip(channel_sizes(size, scale), (quality, quality / 2, quality / 2)):
        hp, wp = padded(ch, patch)
        m, n = (hp // patch[0]) * (wp // patch[1]), patch[0] * patch[1]
        out.append(max(round(min(m, n) * q / 100), 1))
    return out


def metadata(size, quality: float, bounds=(-16, 15), scale=(0.5, 0.5), patch=(8, 8)) -> dict:
    """The stream metadata a YCbCr patch encode of `size` images writes."""
    chans = channel_sizes(size, scale)
    return {
        "dtype": "uint8",
        "color space": "YCbCr",
        "patch": True,
        "bounds": list(bounds),
        "patch size": list(patch),
        "original size": [list(s) for s in chans],
        "padded size": [padded(s, patch) for s in chans],
        "rank": ranks(size, quality, scale, patch),
    }


def patch_stacks(images: np.ndarray, device, precision="float32", scale=(0.5, 0.5), patch=(8, 8)):
    """The three `(B, M, p*q)` patch stacks (Y, Cb, Cr) of uint8 RGB images."""
    x = rgb_to_ycbcr(torch.from_numpy(np.ascontiguousarray(images)).to(device), precision)
    h, w = x.shape[-2:]
    ch = channel_sizes((h, w), scale)[1]
    out = []
    for i in range(3):
        c = x[:, i:i + 1]
        if i:
            c = _pool_axis(_pool_axis(c, ch[0], c.ndim - 2), ch[1], c.ndim - 1)
        c = _reflect_pad(c, patch)
        b, cc, hh, ww = c.shape
        hp, wp = hh // patch[0], ww // patch[1]
        c = c.reshape(b, cc, hp, patch[0], wp, patch[1]).permute(0, 2, 4, 1, 3, 5)
        out.append(c.reshape(b, hp * wp, cc * patch[0] * patch[1]))
    return out


def _project(x: torch.Tensor, bounds) -> torch.Tensor:
    return torch.clamp(torch.round(x), math.ceil(bounds[0]), math.floor(bounds[1]))


def _clip_penalty(z: torch.Tensor, bounds) -> torch.Tensor:
    over = torch.clamp(z - math.floor(bounds[1]), min=0.0)
    under = torch.clamp(math.ceil(bounds[0]) - z, min=0.0)
    return torch.sum(over * over + under * under, dim=-2, keepdim=True)


def svd_init(x: torch.Tensor, rank: int, bounds, precision="float32"):
    """`(u, v)`: the top `rank` pairs of X's SVD through its column Gram,
    each factor scaled by sqrt(s), each pair signed to clip less."""
    val, wide = _dtypes(precision)
    xw = x.to(wide)
    g = torch.matmul(xw.transpose(-1, -2), xw)
    g = g.to(torch.float32).cpu().numpy()  # LAPACK has no bfloat16: the eigh runs in float32 then
    evals = np.empty(g.shape[:-1], np.float32)
    evecs = np.empty_like(g)
    for i in range(g.shape[0]):
        evals[i], evecs[i] = scipy.linalg.eigh(g[i], driver="evd")
    r = min(rank, x.shape[-2], x.shape[-1])
    ev = torch.from_numpy(evals[:, ::-1][:, :r].copy()).to(x.device)
    v = torch.from_numpy(evecs[:, :, ::-1][:, :, :r].copy()).to(x.device).to(val)
    s = torch.sqrt(torch.clamp(ev, min=0.0).to(wide)).to(val)
    tiny = torch.finfo(val).tiny ** 0.5
    xv = torch.matmul(xw, v.to(wide)).to(val)
    u = (xv.to(wide) / torch.clamp(s, min=tiny).to(wide)[:, None, :]).to(val)
    rs = torch.sqrt(s.to(wide)).to(val)[:, None, :]
    u, v = u * rs, v * rs
    if r < rank:
        u = torch.nn.functional.pad(u, (0, rank - r))
        v = torch.nn.functional.pad(v, (0, rank - r))
    pos = _clip_penalty(u, bounds) + _clip_penalty(v, bounds)
    neg = _clip_penalty(-u, bounds) + _clip_penalty(-v, bounds)
    sign = torch.where(neg < pos, -1.0, 1.0).to(val)
    return u * sign, v * sign


def _update(a: torch.Tensor, b: torch.Tensor, f: torch.Tensor, bounds) -> torch.Tensor:
    """One Gauss-Seidel pass over the columns of `f`, given `a = X G` and
    `b = G^T G` for the other factor G."""
    f = f.clone()
    for r in range(f.shape[-1]):
        rest = torch.matmul(f, b[..., :, r:r + 1]) - f[..., r:r + 1] * b[..., r:r + 1, r:r + 1]
        f[..., r:r + 1] = _project((a[..., r:r + 1] - rest + EPS) / (b[..., r:r + 1, r:r + 1] + EPS), bounds)
    return f


def bcd(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor, num_iters: int, bounds):
    """`num_iters` sweeps: every column of U, then every column of V."""
    for _ in range(num_iters):
        u = _update(torch.matmul(x, v), torch.matmul(v.transpose(-1, -2), v), u, bounds)
        v = _update(torch.matmul(x.transpose(-1, -2), u), torch.matmul(u.transpose(-1, -2), u), v, bounds)
    return u, v


def encode_factors(images: np.ndarray, quality: float, bounds=(-16, 15), num_iters: int = 10, device="cpu",
                   precision: str = "float32", scale=(0.5, 0.5), patch=(8, 8)) -> list[np.ndarray]:
    """The six int8 factors `[U_y, V_y, U_cb, V_cb, U_cr, V_cr]`, each
    `(B, ., R)`, of a plain QMF encode of uint8 `(B, 3, H, W)` images."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products stay float32 on the card
    try:
        rs = ranks(images.shape[-2:], quality, scale, patch)
        out = []
        for x, r in zip(patch_stacks(images, device, precision, scale, patch), rs):
            u, v = svd_init(x, r, bounds, precision)
            u, v = bcd(x, u, v, num_iters, bounds)
            out += [u.to(torch.int8).cpu().numpy(), v.to(torch.int8).cpu().numpy()]
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _split(blob: bytes, count: int) -> list[bytes]:
    """Payloads of `count` left-folded `len(p1) (4 bytes, big-endian) || p1 || p2` frames."""
    out = []
    head = blob
    for _ in range(count - 1):
        if len(head) < 4:
            raise ValueError("frame too short")
        n = int.from_bytes(head[:4], "big")
        if n > len(head) - 4:
            raise ValueError("frame length past the end")
        head, tail = head[4:4 + n], head[4 + n:]
        out.insert(0, tail)
    out.insert(0, head)
    return out


def parse_stream(stream: bytes):
    """`(metadata, [U_y, V_y, U_cb, V_cb, U_cr, V_cr])` of one YCbCr patch
    stream, the factors as int8 `(M, R)` arrays. Raises ValueError on any
    frame, JSON or zlib fault."""
    try:
        head, body = _split(stream, 2)
        md = json.loads(head.decode("utf-8"))
        factors = []
        for blob in _split(body, 6):
            inner, fibers = _split(blob, 2)
            info = json.loads(inner.decode("utf-8"))
            if info.get("mode") != "col" or info.get("dtype") != "int8":
                raise ValueError(f"factor framed as {info}")
            cols = [np.frombuffer(zlib.decompress(f), np.int8) for f in _split(fibers, int(info["num_fibers"]))]
            if len({c.size for c in cols}) != 1:
                raise ValueError("fibers of unequal length")
            factors.append(np.stack(cols, axis=1))
    except (UnicodeDecodeError, json.JSONDecodeError, zlib.error, KeyError, TypeError) as e:
        raise ValueError(f"unreadable stream: {e}") from e
    return md, factors


def decode(md: dict, factors: list[np.ndarray], device="cpu", precision: str = "float32") -> np.ndarray:
    """uint8 `(B, 3, H, W)` pixels from the six batched `(B, ., R)` factors."""
    val, _ = _dtypes(precision)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        patch = md["patch size"]
        chans = []
        for i in range(3):
            u = torch.from_numpy(np.ascontiguousarray(factors[2 * i])).to(device).to(val)
            v = torch.from_numpy(np.ascontiguousarray(factors[2 * i + 1])).to(device).to(val)
            x = torch.matmul(u, v.transpose(-1, -2))
            hp, wp = md["padded size"][i]
            h, w = md["original size"][i]
            b = x.shape[0]
            x = x.reshape(b, hp // patch[0], wp // patch[1], 1, patch[0], patch[1]).permute(0, 3, 1, 4, 2, 5)
            x = x.reshape(b, 1, hp, wp)
            top, left = (hp - h) // 2, (wp - w) // 2
            chans.append(x[..., top:top + h, left:left + w])
        h, w = md["original size"][0]
        for i in (1, 2):
            ch, cw = chans[i].shape[-2:]
            rows = torch.from_numpy(np.floor(np.arange(h) * ch / h).astype(np.int64)).to(device)
            cols = torch.from_numpy(np.floor(np.arange(w) * cw / w).astype(np.int64)).to(device)
            chans[i] = torch.index_select(torch.index_select(chans[i], 2, rows), 3, cols)
        rgb = ycbcr_to_rgb(torch.cat(chans, dim=1), precision)
        return torch.clamp(rgb, 0, 255).to(torch.uint8).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
