"""The arithmetic and launch plans of the port's CUDA kernels, where no GPU
runs them.

  * The bit-to-byte map of the int8 tensor-core products (pair stats, B3,
    in `csrc/hamming.cu`, and top-k select, B2, in `csrc/topk_select.cu`):
    packed words are unpacked into 0/1 bytes in the kernels' order, placed
    into operands by the lane layout of PTX's
    `mma.m16n8k32.row.col.s32.s8.s8.s32` (per warp also wgmma's k32 A from
    registers) and, for pair stats' B, by the shared-memory layout its
    wgmma descriptor reads, and multiplied in int32.  The sums equal `pair_stats_ref`'s inner exactly,
    and wa + wb - 2 * inner its Hamming distances.
  * The sparse Cabin kernel's (B1) launch plan.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.cabin_build_sparse import ops as sparse_ops
from repro_torch.kernels.hamming.ref import pair_stats_ref, row_popcount_ref

ONES = np.uint32(0x01010101)
# pair stats' unpacked query words as wgmma's K-major B operand in shared
# memory: core matrices of 8 columns x 16 k-bytes, the second k-half LBO
# bytes after the first, groups of 8 columns SBO bytes apart
CORE_LBO, CORE_SBO = 128, 256


def bit_bytes(x: np.ndarray, r: int) -> np.ndarray:
    """k-bytes 4r .. 4r + 3 of packed words x as one register: bits r,
    r + 8, r + 16, r + 24 as bytes 0 or 1."""
    return (x >> np.uint32(r)) & ONES


def reg_bytes(reg: np.ndarray) -> np.ndarray:
    """(..., ) uint32 registers -> (..., 4) bytes, byte 0 the lowest."""
    return reg.astype("<u4").view(np.uint8).reshape(reg.shape + (4,))


def a_operand(rows: np.ndarray) -> np.ndarray:
    """16 rows (16, W) uint32 -> (W, 16, 32) int8: the A operand of one
    product per word, assembled from the registers each lane builds from
    the packed words (lane grp, tig: registers tig and tig + 4 of rows grp
    and grp + 8) at the positions PTX assigns them: register i of a lane
    holds row grp + 8 (i % 2), k-bytes 4 tig + 16 (i // 2) .. + 3."""
    w = rows.shape[1]
    a = np.full((w, 16, 32), -1, np.int8)
    for lane in range(32):
        grp, tig = divmod(lane, 4)
        lo, hi = rows[grp], rows[grp + 8]
        regs = (bit_bytes(lo, tig), bit_bytes(hi, tig),
                bit_bytes(lo, tig + 4), bit_bytes(hi, tig + 4))
        for i, reg in enumerate(regs):
            k0 = 4 * tig + 16 * (i // 2)
            a[:, grp + 8 * (i % 2), k0:k0 + 4] = reg_bytes(reg)
    return a


def b_operand(cols: np.ndarray) -> np.ndarray:
    """8 columns (8, W) uint32 -> (W, 32, 8) int8: the B operand of one
    mma.m16n8k32 per word as top-k select builds it from the packed words,
    lane (grp, tig)'s registers b0 = bit_bytes(tig) (k-bytes 4 tig .. + 3)
    and b1 = bit_bytes(tig + 4) (16 + 4 tig .. + 3) of column grp."""
    w = cols.shape[1]
    b = np.full((w, 32, 8), -1, np.int8)
    for lane in range(32):
        grp, tig = divmod(lane, 4)
        x = cols[grp]
        for i, reg in enumerate((bit_bytes(x, tig), bit_bytes(x, tig + 4))):
            k0 = 4 * tig + 16 * i
            b[:, k0:k0 + 4, grp] = reg_bytes(reg)
    return b


def b_operand_wgmma(cols: np.ndarray) -> np.ndarray:
    """n columns (n, W) uint32, n a multiple of 8 -> (W, 32, n) int8: the B
    operand of one wgmma k32 per word as pair stats lays it out.  Each
    word is written as the kernel writes it, registers 0-3 of column q at
    byte (q // 8) SBO + (q % 8) 16 and registers 4-7 LBO bytes later, and
    read back as the descriptor addresses a K-major operand: k-byte k of
    column q at (q // 8) SBO + (k // 16) LBO + (q % 8) 16 + k % 16."""
    n, w = cols.shape
    image = np.full((w, n // 8 * CORE_SBO), 0xFF, np.uint8)
    for q in range(n):
        at = q // 8 * CORE_SBO + q % 8 * 16
        regs = np.stack([bit_bytes(cols[q], r) for r in range(8)], axis=1)
        raw = reg_bytes(regs).reshape(w, 32)
        image[:, at:at + 16] = raw[:, :16]
        image[:, at + CORE_LBO:at + CORE_LBO + 16] = raw[:, 16:]
    b = np.empty((w, 32, n), np.int8)
    for q in range(n):
        for k in range(32):
            b[:, k, q] = image[:, q // 8 * CORE_SBO + k // 16 * CORE_LBO
                               + q % 8 * 16 + k % 16].view(np.int8)
    return b


def tensor_core_inner(a: np.ndarray, b: np.ndarray, kernel: str
                      ) -> np.ndarray:
    """a (M, W), b (N, W) packed int32 -> (M, N) int32 inner products as
    the kernels compute them: b's rows on the product's M side in 16-row
    tiles (a warp's share of a wgmma), a's rows on its N side in 8-column
    tiles (top-k select, mma.sync) or 64-column tiles (pair stats, wgmma),
    zero-padded; one product per word, s32 sums."""
    m, w = a.shape
    n = b.shape[0]
    cols = 8 if kernel == "topk_select" else 64
    a_u = np.zeros((-(-m // cols) * cols, w), np.uint32)
    b_u = np.zeros((-(-n // 16) * 16, w), np.uint32)
    a_u[:m] = a.view(np.uint32)
    b_u[:n] = b.view(np.uint32)
    out = np.zeros((a_u.shape[0], b_u.shape[0]), np.int32)
    for r0 in range(0, b_u.shape[0], 16):
        aop = a_operand(b_u[r0:r0 + 16]).astype(np.int32)
        for q0 in range(0, a_u.shape[0], cols):
            tile = a_u[q0:q0 + cols]
            bop = (b_operand(tile) if kernel == "topk_select"
                   else b_operand_wgmma(tile)).astype(np.int32)
            # accumulator (row, query), summed over the words' products
            acc = np.einsum("wrk,wkq->rq", aop, bop)
            out[q0:q0 + cols, r0:r0 + 16] = acc.T
    return out[:m, :n]


@pytest.mark.parametrize("kernel", ["pair_stats", "topk_select"])
@pytest.mark.parametrize("w", [1, 3, 4, 128, 2000])
def test_int8_fragment_map_gives_exact_popcounts(w, kernel):
    rng = np.random.default_rng(w)
    a = rng.integers(-(2**31), 2**31, size=(9, w)).astype(np.int32)
    b = rng.integers(-(2**31), 2**31, size=(21, w)).astype(np.int32)
    b[3] = -1  # every bit set: the largest sum, 32 * W
    b[4] = 0
    a[0] = -1
    inner = tensor_core_inner(a, b, kernel)
    want_inner, want_ham = pair_stats_ref(torch.from_numpy(a),
                                          torch.from_numpy(b))
    np.testing.assert_array_equal(inner, want_inner.numpy())
    assert inner[0, 3] == 32 * w
    wa = row_popcount_ref(torch.from_numpy(a)).numpy()
    wb = row_popcount_ref(torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(wa[:, None] + wb[None, :] - 2 * inner,
                                  want_ham.numpy())


def test_int8_fragment_map_is_a_permutation_of_the_bits():
    """Each of a word's 32 bits lands in exactly one k-byte, for the row
    side and both query sides alike, so the map loses and repeats no bit."""
    for bit in range(32):
        x = np.full((16, 1), 1 << bit, np.uint64).astype(np.uint32)
        for op in (a_operand(x)[0, 0], b_operand(x[:8])[0, :, 0],
                   b_operand_wgmma(x[:8])[0, :, 0]):
            assert sorted(op.tolist()) == [0] * 31 + [1], bit
        k = int(np.flatnonzero(a_operand(x)[0, 0])[0])
        t, i = divmod(k % 16, 4)
        assert bit == t + 4 * (k // 16) + 8 * i  # byte 4t + i <-> bit t + 8i


# (m, d, addresses) -> (vec, rows_per_block, device_bitmap)
PLANS = [
    # the main path: PubMed's 298-slot rows at d = 4096, 8-byte loads
    ((298, 4096, 0, 1 << 20), (2, 8, False)),
    ((296, 4096, 0, 1 << 20), (4, 8, False)),
    ((297, 4096, 0, 1 << 20), (1, 8, False)),
    ((40, 300, 0, 1 << 20), (4, 8, False)),
    # a misaligned row start narrows the load
    ((296, 4096, 8, 1 << 20), (2, 8, False)),
    ((296, 4096, 0, 4), (1, 8, False)),
    ((0, 1, 0, 0), (4, 8, False)),
    ((1, 1, 0, 0), (1, 8, False)),
    # rows a block halve as the bitmaps grow, down to one at MAX_D
    ((298, 232_448, 0, 0), (2, 8, False)),
    ((298, 232_449, 0, 0), (2, 4, False)),
    ((298, 464_896, 0, 0), (2, 4, False)),
    ((298, 929_792, 0, 0), (2, 2, False)),
    ((298, 929_793, 0, 0), (2, 1, False)),
    ((298, sparse_ops.MAX_D, 0, 0), (2, 1, False)),
    # above it the bitmap is the output row in device memory
    ((298, sparse_ops.MAX_D + 1, 0, 0), (2, 1, True)),
    ((7, 2_000_001, 0, 0), (1, 1, True)),
]


@pytest.mark.parametrize("args,want", PLANS,
                         ids=["-".join(map(str, a)) for a, _ in PLANS])
def test_cabin_sparse_plan(args, want):
    m, d, *addresses = args
    p = sparse_ops.plan(m, d, *addresses)
    assert tuple(p) == want
    assert m % p.vec == 0 and all(a % (4 * p.vec) == 0 for a in addresses)
    if not p.device_bitmap:  # the block's bitmaps fit shared memory
        assert p.rows_per_block * -(-d // 32) * 4 <= 232_448
