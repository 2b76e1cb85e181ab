"""Plain baseline JPEG (ITU T.81) for the benchmark's reference: the 4:2:0
transform path in PyTorch, a Huffman decoder of JFIF bytes, and the exact
scan size under the standard Huffman tables.

Written from T.81 and the JFIF note, with the conventions that HyRES
states for its base layer: full-range YCbCr rounded to integers, 2x2 box
downsampling rounded half to even, quantisation rounded half away from
zero and clipped to +-1023, decoding without rounding (dequantise,
inverse DCT, +128, clip to [0, 255]) and triangle ("fancy") chroma
upsampling with clamped edges. Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# natural index of the k-th coefficient in zigzag order (T.81 figure A.6)
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

# T.81 Annex K, tables K.1 and K.2 (natural order)
LUMA_QT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
CHROMA_QT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, np.int64)

# T.81 Annex K.3: (code counts for lengths 1..16, symbols) of the four tables
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52,
    0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3,
    0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8,
    0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33,
    0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18,
    0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA,
    0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7,
    0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])

# bytes of a baseline JFIF file outside its scan: SOI, APP0 (JFIF 1.01),
# two 8-bit DQT, SOF0 of three components, the four Annex K DHT, SOS, EOI
HEADER_BYTES = (2 + 18 + 2 * (4 + 1 + 64) + (2 + 2 + 6 + 3 * 3)
                + sum(4 + 1 + 16 + len(t[1]) for t in (DC_LUMA, AC_LUMA, DC_CHROMA, AC_CHROMA))
                + (2 + 2 + 1 + 3 * 2 + 3) + 2)


def qtables(quality: int):
    """IJG quality scaling of the Annex K tables -> (luma, chroma), natural
    order, int64 in [1, 255]."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (LUMA_QT, CHROMA_QT))


def dct_matrix(device, dtype=torch.float64):
    """D[u, x] = c(u) / 2 cos((2x + 1) u pi / 16), c(0) = 1/sqrt(2)."""
    u = torch.arange(8, dtype=torch.float64)[:, None]
    x = torch.arange(8, dtype=torch.float64)[None, :]
    d = torch.cos((2 * x + 1) * u * math.pi / 16) / 2
    d[0] /= math.sqrt(2)
    return d.to(device=device, dtype=dtype)


def _blocks(p):
    B, H, W = p.shape
    return p.reshape(B, H // 8, 8, W // 8, 8).permute(0, 1, 3, 2, 4)


def _unblocks(b):
    B, nh, nw = b.shape[:3]
    return b.permute(0, 1, 3, 2, 4).reshape(B, nh * 8, nw * 8)


def encode(x, quality: int, dtype=torch.float64):
    """NHWC RGB in [0, 1] (sides multiples of 16) -> quantised Y, Cb, Cr
    coefficient planes (B, nh, nw, 8, 8) int32, natural order; the DCT in
    ``dtype``."""
    r, g, b = x[..., 0] * 255.0, x[..., 1] * 255.0, x[..., 2] * 255.0
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    y, cb, cr = (torch.clamp(torch.round(p), 0.0, 255.0) for p in (y, cb, cr))

    def down(p):
        B, H, W = p.shape
        return torch.round(p.reshape(B, H // 2, 2, W // 2, 2).mean(dim=(2, 4)))

    d = dct_matrix(x.device, dtype)
    out = []
    for plane, q in zip((y, down(cb), down(cr)), qtables(quality) + qtables(quality)[1:]):
        blk = _blocks(plane.to(dtype) - 128.0)
        c = d @ blk @ d.T / torch.as_tensor(q.reshape(8, 8), dtype=dtype, device=x.device)
        c = torch.sign(c) * torch.floor(torch.abs(c) + 0.5)
        out.append(torch.clamp(c, -1023, 1023).to(torch.int32))
    return tuple(out)


def decode(coefs, qts, height: int, width: int, dtype=torch.float32):
    """Coefficient planes + (luma, chroma) quant tables -> NHWC RGB [0, 1]."""
    y, cb, cr = coefs
    d = dct_matrix(y.device, dtype)

    def pix(c, q):
        deq = c.to(dtype) * torch.as_tensor(np.asarray(q).reshape(8, 8), dtype=dtype, device=c.device)
        return torch.clamp(_unblocks(d.T @ deq @ d) + 128.0, 0.0, 255.0)

    def up1(a):
        left = torch.cat([a[..., :1], a[..., :-1]], dim=-1)
        right = torch.cat([a[..., 1:], a[..., -1:]], dim=-1)
        return torch.stack([(3 * a + left) / 4, (3 * a + right) / 4], dim=-1).reshape(
            *a.shape[:-1], -1)

    def up(p):
        return up1(up1(p).transpose(-1, -2)).transpose(-1, -2)

    Y, Cb, Cr = pix(y, qts[0]), up(pix(cb, qts[1])) - 128.0, up(pix(cr, qts[1])) - 128.0
    rgb = torch.stack([Y + 1.402 * Cr, Y - 0.344136286 * Cb - 0.714136286 * Cr,
                       Y + 1.772 * Cb], dim=-1)
    return (torch.clamp(rgb, 0.0, 255.0) / 255.0)[:, :height, :width, :]


# -- exact scan size (training rate) --------------------------------------------------

def _code_lengths(table, n):
    counts, syms = table
    out = np.zeros(n, np.int64)
    k = 0
    for length, c in enumerate(counts, start=1):
        for _ in range(c):
            out[syms[k]] = length
            k += 1
    return out


def _magnitude_bits(v):
    """SSSS of T.81 F.1.2: bits of |v| (0 for 0)."""
    a = v.abs().to(torch.float64)
    return torch.where(a > 0, torch.floor(torch.log2(torch.clamp_min(a, 1))) + 1,
                       torch.zeros_like(a)).to(torch.int64)


def scan_bits(coefs):
    """(B,) int64: bits of each image's baseline scan under the Annex K
    tables, blocks in 4:2:0 MCU order, DC differences per component."""
    y, cb, cr = coefs
    B, nh, nw = y.shape[:3]
    dev = y.device
    L = {k: torch.as_tensor(_code_lengths(t, n), device=dev) for k, t, n in
         (("dcl", DC_LUMA, 12), ("dcc", DC_CHROMA, 12), ("acl", AC_LUMA, 256),
          ("acc", AC_CHROMA, 256))}
    zz = torch.as_tensor(ZIGZAG, device=dev)
    y_seq = y.reshape(B, nh // 2, 2, nw // 2, 2, 64).permute(0, 1, 3, 2, 4, 5).reshape(B, -1, 64)
    total = torch.zeros(B, dtype=torch.int64, device=dev)
    for seq, dc, ac in ((y_seq, L["dcl"], L["acl"]), (cb.reshape(B, -1, 64), L["dcc"], L["acc"]),
                        (cr.reshape(B, -1, 64), L["dcc"], L["acc"])):
        seq = seq[..., zz].to(torch.int64)
        dcv = seq[..., 0]
        diff = dcv - torch.cat([torch.zeros_like(dcv[:, :1]), dcv[:, :-1]], dim=1)
        s = _magnitude_bits(diff)
        total += (dc[s] + s).sum(dim=1)
        v = seq[..., 1:]
        nz = v != 0
        pos = torch.arange(1, 64, device=dev)
        last = torch.cummax(torch.where(nz, pos, torch.zeros_like(pos)), dim=-1).values
        prev = torch.cat([torch.zeros_like(last[..., :1]), last[..., :-1]], dim=-1)
        run = pos - prev - 1
        sz = _magnitude_bits(v)
        code = (run // 16) * ac[0xF0] + ac[(run % 16) * 16 + sz] + sz
        eob = torch.where(last[..., -1] < 63, ac[0x00], torch.zeros_like(last[..., -1]))
        total += (torch.where(nz, code, torch.zeros_like(code)).sum(dim=-1) + eob).sum(dim=1)
    return total


def bpp(coefs, height: int, width: int):
    """Bits per pixel of each image's JFIF file: the scan padded to a byte
    plus the headers."""
    bits = scan_bits(coefs).to(torch.float32)
    return (8.0 * torch.ceil(bits / 8.0) + 8.0 * HEADER_BYTES) / (height * width)


# -- JFIF parsing -----------------------------------------------------------------------

def _lookup(counts, syms):
    """16-bit peek table of a canonical Huffman code: entry -> (symbol, length)."""
    table = [None] * 65536
    code, k = 0, 0
    for length, c in enumerate(counts, start=1):
        for _ in range(c):
            lo = code << (16 - length)
            for e in range(lo, lo + (1 << (16 - length))):
                table[e] = (syms[k], length)
            code += 1
            k += 1
        code <<= 1
    return table


def parse_jfif(data: bytes):
    """Baseline 3-component JFIF bytes -> dict with ``width``, ``height``,
    ``sampling`` (per component (h, v)), ``qt`` (per component, natural
    order) and ``coefs`` (per component (nh, nw, 8, 8) int32). Raises
    ValueError on anything it does not read."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("no SOI")
    pos, qt, huff, comps, scan = 2, {}, {}, None, None
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError("marker expected")
        m = data[pos + 1]
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        seg = data[pos + 4:pos + 2 + n]
        if m == 0xDB:
            i = 0
            while i < len(seg):
                if seg[i] >> 4:
                    raise ValueError("16-bit quant table")
                zzv = np.frombuffer(seg[i + 1:i + 65], np.uint8).astype(np.int64)
                nat = np.zeros(64, np.int64)
                nat[ZIGZAG] = zzv
                qt[seg[i] & 15] = nat
                i += 65
        elif m == 0xC0:
            height, width = int.from_bytes(seg[1:3], "big"), int.from_bytes(seg[3:5], "big")
            comps = [(seg[6 + 3 * c], seg[7 + 3 * c] >> 4, seg[7 + 3 * c] & 15, seg[8 + 3 * c])
                     for c in range(seg[5])]
        elif m == 0xC4:
            i = 0
            while i < len(seg):
                counts = list(seg[i + 1:i + 17])
                syms = list(seg[i + 17:i + 17 + sum(counts)])
                huff[(seg[i] >> 4, seg[i] & 15)] = _lookup(counts, syms)
                i += 17 + sum(counts)
        elif m == 0xDA:
            sel = {seg[1 + 2 * c]: (seg[2 + 2 * c] >> 4, seg[2 + 2 * c] & 15)
                   for c in range(seg[0])}
            end = data.rfind(b"\xff\xd9")
            scan = data[pos + 2 + n:end].replace(b"\xff\x00", b"\xff")
            break
        elif m in (0xDD,) or 0xC1 <= m <= 0xCF:
            raise ValueError(f"unsupported marker 0x{m:02x}")
        pos += 2 + n
    if comps is None or scan is None:
        raise ValueError("no frame or no scan")
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    out = [np.zeros((mcuy * c[2], mcux * c[1], 64), np.int32) for c in comps]
    buf = scan + b"\x00\x00\x00\x00"
    bitpos = 0

    def peek16():
        b = bitpos >> 3
        return (int.from_bytes(buf[b:b + 3], "big") >> (8 - (bitpos & 7))) & 0xFFFF

    def receive(s):
        nonlocal bitpos
        if s == 0:
            return 0
        b = bitpos >> 3
        v = (int.from_bytes(buf[b:b + 4], "big") >> (32 - (bitpos & 7) - s)) & ((1 << s) - 1)
        bitpos += s
        return v if v >= 1 << (s - 1) else v - (1 << s) + 1

    pred = [0] * len(comps)
    for my in range(mcuy):
        for mx in range(mcux):
            for ci, (cid, h, v, _) in enumerate(comps):
                dct_t, act_t = sel[cid]
                dtab, atab = huff[(0, dct_t)], huff[(1, act_t)]
                for by in range(v):
                    for bx in range(h):
                        blk = out[ci][my * v + by, mx * h + bx]
                        s, ln = dtab[peek16()]
                        bitpos += ln
                        pred[ci] += receive(s)
                        blk[0] = pred[ci]
                        k = 1
                        while k < 64:
                            rs, ln = atab[peek16()]
                            bitpos += ln
                            r, s = rs >> 4, rs & 15
                            if s == 0:
                                if r != 15:
                                    break
                                k += 16
                                continue
                            k += r
                            blk[ZIGZAG[k]] = receive(s)
                            k += 1
    if bitpos > 8 * len(scan):
        raise ValueError("scan ends early")
    return {"width": width, "height": height, "sampling": [(c[1], c[2]) for c in comps],
            "qt": [qt[c[3]] for c in comps],
            "coefs": [o.reshape(o.shape[0], o.shape[1], 8, 8) for o in out]}
