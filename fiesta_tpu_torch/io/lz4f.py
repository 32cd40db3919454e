"""Pure-Python LZ4 frame codec (the subset rosbag's lz4 chunks use).

A copy of ``fiesta_tpu/io/lz4f.py`` (pure Python), so that the port reads
lz4-compressed bags without importing the JAX package.

The reference's operating procedure is ``rosbag play data.bag``
(reference README.md:88-96); recorded bags are commonly chunk-compressed
with roslz4, which emits the standard **LZ4 Frame format** (magic
0x184D2204) around raw LZ4 blocks.  No lz4 binding is required: both
directions are implemented from the public specs:

  * LZ4 Frame Format v1.6.1 (magic, FLG/BD descriptor, xxHash32 header
    checksum, u32-prefixed blocks with a high-bit "uncompressed" flag,
    EndMark, optional content checksum);
  * LZ4 Block Format (token = literal-length nibble | match-length
    nibble, 255-byte length extensions, little-endian u16 match offsets,
    overlap-capable match copies, end-of-block rules: last 5 bytes are
    literals, no match starts within 12 bytes of the end);
  * xxHash32 (header + content checksums).

The compressor is greedy with a 4-byte hash table — modest ratios, spec-
conformant output; the decompressor accepts any conformant frame
(independent OR linked blocks; linked blocks thread the previous 64 KiB
of decoded output as match history, and rosbag chunks are single-block in
practice).

Performance: this codec is O(n) PYTHON-level loops (xxh32 advances 4
bytes per iteration, the compressor keeps a dict-of-bytes hash table per
block, overlap copies are byte-wise) — expect roughly 1-10 MB/s, orders
of magnitude slower than a native lz4 binding.  When the optional
``lz4.frame`` package is importable it is used instead (same frame
format); the pure-Python path is the zero-dependency fallback.
"""

from __future__ import annotations

import struct

try:                      # optional native binding (not in this image)
    import lz4.frame as _lz4frame   # type: ignore
except Exception:          # pragma: no cover - absent here
    _lz4frame = None

MAGIC = 0x184D2204

# xxHash32 primes
_P1 = 2654435761
_P2 = 2246822519
_P3 = 3266489917
_P4 = 668265263
_P5 = 374761393
_M32 = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32 of ``data`` (reference algorithm, public domain spec)."""
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _P1 + _P2) & _M32
        v2 = (seed + _P2) & _M32
        v3 = seed & _M32
        v4 = (seed - _P1) & _M32
        limit = n - 16
        while i <= limit:
            (a, b, c, d) = struct.unpack_from("<IIII", data, i)
            v1 = (_rotl((v1 + a * _P2) & _M32, 13) * _P1) & _M32
            v2 = (_rotl((v2 + b * _P2) & _M32, 13) * _P1) & _M32
            v3 = (_rotl((v3 + c * _P2) & _M32, 13) * _P1) & _M32
            v4 = (_rotl((v4 + d * _P2) & _M32, 13) * _P1) & _M32
            i += 16
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M32
    else:
        h = (seed + _P5) & _M32
    h = (h + n) & _M32
    while i + 4 <= n:
        (k,) = struct.unpack_from("<I", data, i)
        h = (_rotl((h + k * _P3) & _M32, 17) * _P4) & _M32
        i += 4
    while i < n:
        h = (_rotl((h + data[i] * _P5) & _M32, 11) * _P1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _P2) & _M32
    h ^= h >> 13
    h = (h * _P3) & _M32
    h ^= h >> 16
    return h


class LZ4Error(ValueError):
    pass


# ---------------------------------------------------------------------------
# Block codec
# ---------------------------------------------------------------------------


def decompress_block(src: bytes, max_size: int | None = None,
                     prefix: bytes = b"") -> bytes:
    """Decode one raw LZ4 block.

    ``prefix``: match history from preceding blocks (linked-block frames,
    FLG bit 5 clear) — matches may reach up to 64 KiB back into it.
    Returns only the newly decoded bytes.
    """
    out = bytearray()
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        # literals
        ll = token >> 4
        if ll == 15:
            while True:
                if i >= n:
                    raise LZ4Error("truncated literal length")
                b = src[i]
                i += 1
                ll += b
                if b != 255:
                    break
        if i + ll > n:
            raise LZ4Error("literal run past end of block")
        out += src[i:i + ll]
        i += ll
        if i == n:
            break                      # last sequence: literals only
        # match
        if i + 2 > n:
            raise LZ4Error("truncated match offset")
        off = src[i] | (src[i + 1] << 8)
        i += 2
        if off == 0:
            raise LZ4Error("zero match offset")
        ml = token & 0xF
        if ml == 15:
            while True:
                if i >= n:
                    raise LZ4Error("truncated match length")
                b = src[i]
                i += 1
                ml += b
                if b != 255:
                    break
        ml += 4
        start = len(out) - off
        if start < 0:
            # linked-block frame: the match begins in the history window
            if len(prefix) + start < 0:
                raise LZ4Error("match offset before history window")
            if start + ml <= 0:            # fully inside the prefix
                p0 = len(prefix) + start
                out += prefix[p0:p0 + ml]
            else:                          # crosses into this block
                for k in range(ml):
                    p = start + k
                    out.append(out[p] if p >= 0
                               else prefix[len(prefix) + p])
        elif off >= ml:
            out += out[start:start + ml]
        else:
            # overlapping copy (e.g. RLE with offset 1): byte-sequential
            for k in range(ml):
                out.append(out[start + k])
        if max_size is not None and len(out) > max_size:
            raise LZ4Error("block exceeds declared content size")
    return bytes(out)


def _emit_sequence(out: bytearray, literals: bytes, off: int, mlen: int):
    """Append one LZ4 sequence; mlen == 0 means final literals-only."""
    ll = len(literals)
    tok_l = min(ll, 15)
    if mlen:
        ml = mlen - 4
        tok_m = min(ml, 15)
    else:
        ml = tok_m = 0
    out.append((tok_l << 4) | tok_m)
    if tok_l == 15:
        rest = ll - 15
        while rest >= 255:
            out.append(255)
            rest -= 255
        out.append(rest)
    out += literals
    if mlen:
        out += struct.pack("<H", off)
        if tok_m == 15:
            rest = ml - 15
            while rest >= 255:
                out.append(255)
                rest -= 255
            out.append(rest)


def compress_block(src: bytes) -> bytes:
    """Greedy LZ4 block compressor (4-byte hash matching).

    Conforms to the block end rules: the last 5 bytes are always emitted
    as literals and no match extends into them or starts within 12 bytes
    of the end.
    """
    n = len(src)
    out = bytearray()
    if n == 0:
        out.append(0)                  # single empty-literals token
        return bytes(out)
    anchor = 0
    i = 0
    mflimit = n - 12                   # last match must start before this
    match_limit = n - 5                # matches must not cover last 5 bytes
    table: dict[bytes, int] = {}
    while i <= mflimit:
        seq = src[i:i + 4]
        j = table.get(seq, -1)
        table[seq] = i
        if j >= 0 and i - j <= 65535:
            mlen = 4
            while i + mlen < match_limit and src[j + mlen] == src[i + mlen]:
                mlen += 1
            _emit_sequence(out, src[anchor:i], i - j, mlen)
            i += mlen
            anchor = i
        else:
            i += 1
    _emit_sequence(out, src[anchor:], 0, 0)
    return bytes(out)


# ---------------------------------------------------------------------------
# Frame codec
# ---------------------------------------------------------------------------

# BD block-max-size ids (spec table); used for header emission/validation
_BLOCK_SIZES = {4: 64 << 10, 5: 256 << 10, 6: 1 << 20, 7: 4 << 20}


def compress_frame(data: bytes, block_size_id: int = 6,
                   content_checksum: bool = True) -> bytes:
    """Encode ``data`` as one LZ4 frame (independent blocks, no block
    checksums, optional content checksum — the shape roslz4 writes)."""
    if block_size_id not in _BLOCK_SIZES:
        raise ValueError(f"bad block size id {block_size_id}")
    bmax = _BLOCK_SIZES[block_size_id]
    flg = (1 << 6) | (1 << 5) | ((1 << 2) if content_checksum else 0)
    bd = block_size_id << 4
    header = bytes([flg, bd])
    hc = (xxh32(header) >> 8) & 0xFF
    out = bytearray(struct.pack("<I", MAGIC) + header + bytes([hc]))
    # empty input: no data blocks at all, just the EndMark (the canonical
    # encoding; a zero-length block word would collide with EndMark's 0)
    for pos in range(0, len(data), bmax):
        chunk = data[pos:pos + bmax]
        comp = compress_block(chunk)
        if len(comp) < len(chunk):
            out += struct.pack("<I", len(comp))
            out += comp
        else:                          # incompressible: store raw
            out += struct.pack("<I", len(chunk) | 0x80000000)
            out += chunk
    out += struct.pack("<I", 0)        # EndMark
    if content_checksum:
        out += struct.pack("<I", xxh32(data))
    return bytes(out)


def decompress_frame(data: bytes) -> bytes:
    """Decode one LZ4 frame (any conformant header; checksums verified)."""
    if _lz4frame is not None:
        # native binding: ~100x the pure-Python throughput, same format
        return _lz4frame.decompress(data)
    if len(data) < 7:
        raise LZ4Error("frame too short")
    (magic,) = struct.unpack_from("<I", data, 0)
    if magic != MAGIC:
        raise LZ4Error(f"bad LZ4 frame magic {magic:#x}")
    flg = data[4]
    bd = data[5]
    version = flg >> 6
    if version != 1:
        raise LZ4Error(f"unsupported frame version {version}")
    block_checksum = bool(flg & (1 << 4))
    independent = bool(flg & (1 << 5))
    has_content_size = bool(flg & (1 << 3))
    has_content_checksum = bool(flg & (1 << 2))
    has_dict_id = bool(flg & 1)
    i = 6
    content_size = None
    if has_content_size:
        if i + 8 > len(data):
            raise LZ4Error("truncated frame header (content size)")
        (content_size,) = struct.unpack_from("<Q", data, i)
        i += 8
    if has_dict_id:
        i += 4
    if i >= len(data):
        raise LZ4Error("truncated frame header")
    hc = data[i]
    i += 1
    want = (xxh32(data[4:i - 1]) >> 8) & 0xFF
    if hc != want:
        raise LZ4Error(f"header checksum mismatch ({hc:#x} != {want:#x})")
    bmax = _BLOCK_SIZES.get(bd >> 4)
    if bmax is None:
        raise LZ4Error(f"bad BD byte {bd:#x}")

    out = bytearray()
    while True:
        if i + 4 > len(data):
            raise LZ4Error("missing EndMark")
        (bsz,) = struct.unpack_from("<I", data, i)
        i += 4
        if bsz == 0:
            break                      # EndMark
        raw = bool(bsz & 0x80000000)
        bsz &= 0x7FFFFFFF
        if i + bsz > len(data):
            raise LZ4Error("truncated block")
        block = data[i:i + bsz]
        i += bsz
        if block_checksum:
            if i + 4 > len(data):
                raise LZ4Error("truncated block checksum")
            (bc,) = struct.unpack_from("<I", data, i)
            i += 4
            if bc != xxh32(block):
                raise LZ4Error("block checksum mismatch")
        if raw:
            out += block
        else:
            hist = b"" if independent else bytes(out[-65536:])
            out += decompress_block(block, bmax, prefix=hist)
    if has_content_checksum:
        if i + 4 > len(data):
            raise LZ4Error("missing content checksum")
        (cc,) = struct.unpack_from("<I", data, i)
        if cc != xxh32(bytes(out)):
            raise LZ4Error("content checksum mismatch")
    if content_size is not None and content_size != len(out):
        raise LZ4Error(
            f"content size mismatch ({len(out)} != declared {content_size})")
    return bytes(out)
