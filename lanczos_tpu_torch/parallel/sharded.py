"""Row-partitioned operators over ``torch.distributed`` (port of
``lanczos_tpu.parallel.sharded``).

The scaling axis is the same as the JAX package's: the problem dimension n
is split into equal, contiguous row slabs, one per rank of a process group
(:class:`~lanczos_tpu_torch.parallel.mesh.RowMesh`).  Where the JAX package
runs one controller and lets GSPMD turn each reduction into a psum and each
``shard_map`` body into per-device code, here every rank is its own process
and runs the engines on its own slab:

* Krylov vectors and basis rows are this rank's slab (``n_local`` rows of
  the padded problem); the engines' reductions all-reduce over
  :attr:`ShardedOperator.group` (``core/linalg.py``).
* The matvec is the one operation that moves vector data between ranks, by
  explicit collectives: an all-gather of the input (``comm='gather'``), two
  neighbour exchanges (``'ring'``) or one exchange of just the touched
  column blocks per owner hop (``'footprint'``), each issued before the
  local product that does not need it.
* ``matvec`` takes and returns slabs; :meth:`ShardedOperator.scatter` and
  :meth:`ShardedOperator.gather` convert from and to the global vector
  (trimmed to n), as ``LambdaLanczos`` does for start vectors and results.

The local SpMV of :class:`ShardedBSROperator` is kernel K2
(:func:`~lanczos_tpu_torch.ops.spmv.bsr_matvec_rsmk`, ``csrc/bsr_spmv.cu``)
on CUDA tensors, for every tile group, and its plain version on the CPU.

``matvec_f64`` (the precise paths' float64 product, the JAX package's
``matvec_df``) runs the same schedule on a float64 slab: the same
collectives carry float64 words, and the local products are float64 (K1x's
rsmk form for float32 tiles on CUDA; the DIA and dense slabs convert their
entries).  Every engine runs on these slabs (hybrid, fused, thick, block,
block-thick, filtered, the Exponentiator, precise or not).

Complex entries (complex64, complex128) take the same schedules: the
gathers, ring and footprint exchanges and DIA halos carry complex slabs
(``torch.distributed`` moves a complex tensor as its real view), and the
local product is K2's complex instance on CUDA.

bfloat16 tiles (storage only, as :class:`~lanczos_tpu_torch.ops.operators.
BSROperator`'s) are regrouped on the host as their 16-bit words and meet
float32 slabs: K2's bfloat16 instance, and K1x-rsmk's against float64 ones.

:class:`ShardedDenseOperator2D` splits a dense operator over a 2-D
:class:`~lanczos_tpu_torch.parallel.mesh.GridMesh` instead: row slabs of the
vector over one axis, the partial products summed over the other.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core.linalg import reduce_sum
from ..core.types import is_bfloat16, pack_dtype
from ..ops import spmv
from ..ops.operators import DenseOperator, DIAOperator, LinearOperator, _pack_bsr, _sum_dtype, dia_abs_row_sums
from .mesh import GridMesh, RowMesh, all_gather, gather_vector, shard_vector

__all__ = [
    "ShardedOperator",
    "ShardedBSROperator",
    "ShardedDIAOperator",
    "ShardedDenseOperator",
    "ShardedDenseOperator2D",
    "shard_operator",
    "sharded_base",
    "draw_group",
]

class ShardedOperator(LinearOperator):
    """A row-partitioned operator: ``n`` global rows, padded to
    ``n_padded``, of which this rank holds the slab of ``n_local`` rows on
    ``mesh.device``."""

    mesh: RowMesh
    n: int
    n_padded: int

    @property
    def group(self):
        """The process group the engines' reductions all-reduce over."""
        return self.mesh.group

    @property
    def draw_group(self):
        """The ranks that run one solve over this operator and so draw the
        same random vectors (``utils/random.py``): ``group``."""
        return self.group

    @property
    def n_local(self) -> int:
        return self.n_padded // self.mesh.size

    @property
    def device(self):
        return self.mesh.device

    def scatter(self, x):
        """This rank's slab of the global vector ``x`` (length <= n_padded;
        the padding is zero)."""
        return shard_vector(x, self.mesh, self.n_padded)

    def gather(self, y_local):
        """The global vector, trimmed to n, from every rank's slab."""
        return gather_vector(y_local, self.mesh, self.n)

    def matvec_f64(self, x):
        """A x on slabs in float64, for a float64 slab ``x``: the matvec's
        schedule with float64 words and float64 local products."""
        return self.matvec(x)  # each subclass's matvec computes in x's dtype

    def _real_rows(self, sums):
        """``sums`` over this rank's slab cut to the rows below n (the
        padding dropped)."""
        return sums[: max(min(self.n - self.mesh.rank * self.n_local, self.n_local), 0)]

    def _check_slab(self, x):
        if x.shape != (self.n_local,):
            raise ValueError(f"matvec takes this rank's slab of {self.n_local} rows, got shape {tuple(x.shape)}")


def sharded_base(op):
    """The row-partitioned operator that ``op`` is, or wraps through the
    ``base`` (float64 views, shift-squared and scaled operators) or ``op``
    (Chebyshev filters, shift-invert) of its wrappers; None when there is
    none.  The engines find the process group as ``op.group``; the draws
    that must be cut into slabs and the results that must be gathered use
    this operator's ``scatter``, ``gather`` and ``n_local``."""
    while op is not None and not isinstance(op, ShardedOperator):
        op = getattr(op, "base", None) if hasattr(op, "base") else getattr(op, "op", None)
    return op


def draw_group(op):
    """The process group over which the random draws of a solve on ``op``
    (start vectors, block repairs, the filter's probe) are made alike: its
    row-partitioned operator's ``draw_group``, or None on one device."""
    base = sharded_base(op)
    return None if base is None else base.draw_group


def _exchange(mesh: RowMesh, sends, recvs):
    """Start the point-to-point transfers ``sends`` and ``recvs``, lists of
    ``(tensor, peer rank in the mesh, tag)``, together; returns the works to
    wait on.  Peers outside the mesh are skipped, so a receive buffer whose
    sender does not exist keeps its zeros.  NCCL ignores the tags and pairs
    the transfers between two ranks in the order they are issued; every
    caller sends at most one tensor to each peer, so the pairs match on
    both backends (four cards of one host, ``parallel/multichip.py``)."""
    ops = [
        dist.P2POp(fn, t, dist.get_global_rank(mesh.group, peer), mesh.group, tag)
        for fn, items in ((dist.isend, sends), (dist.irecv, recvs))
        for t, peer, tag in items
        if 0 <= peer < mesh.size
    ]
    return dist.batch_isend_irecv(ops) if ops else []


def _wait(works) -> None:
    for w in works:
        w.wait()


def _tile_group(blocks, cb, sel, cb_of, bm, bk):
    """The tiles selected by ``sel`` (R, S), moved to the front of their row
    block in ascending column order (the JAX packer's order), with column
    ids ``cb_of(i, j)``; returns ``(tiles (R, S_g, bm, bk), col_blocks
    (R, S_g) int32)``, S_g >= 1."""
    r = sel.shape[0]
    s_g = max(int(sel.sum(axis=1).max(initial=0)), 1)
    ii, jj = np.nonzero(sel)
    slot = (np.cumsum(sel, axis=1) - 1)[ii, jj]
    tiles = np.zeros((r, s_g, bm, bk), blocks.dtype)
    cbg = np.zeros((r, s_g), np.int32)
    tiles[ii, slot] = blocks[ii, jj]
    cbg[ii, slot] = cb_of(ii, jj)
    return tiles, cbg


def _tiles_tensor(tiles, device):
    """Host tiles on ``device``: a numpy array, or bfloat16 tiles held as
    their uint16 words (viewed back as ``torch.bfloat16``)."""
    tiles = np.ascontiguousarray(tiles)
    if tiles.dtype == np.uint16:
        return torch.from_numpy(tiles.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(tiles).to(device)


def _tile_pattern(rows, cols, vals, n_pad, bm, bk, np_dtype, bf16, nonzero=True):
    """The pattern of the tiles that ``_pack_bsr`` packs from these COO
    triplets over ``n_pad`` rows, without packing a tile: the column blocks
    ``cb`` (R, S) int32 and, with ``nonzero``, which tiles hold a nonzero
    entry (R, S) once duplicates are summed in ``np_dtype`` in the input
    order (``np.add.at``, as the packer sums them) and, for bfloat16 tiles,
    rounded to their 16-bit words; else None."""
    span = bm * bk
    ncb, r = n_pad // bk, n_pad // bm
    # entry keys ordered by tile id (row block * ncb + column block) first
    key = ((rows // bm) * ncb + cols // bk) * span + (rows % bm) * bk + cols % bk
    entries, inv = np.unique(key, return_inverse=True)
    tile = entries // span
    first = np.flatnonzero(np.r_[True, tile[1:] != tile[:-1]]) if tile.size else np.zeros(0, np.int64)
    block_ids = tile[first]
    rb = block_ids // ncb
    counts = np.bincount(rb, minlength=r)
    slot = np.arange(block_ids.shape[0]) - np.r_[0, np.cumsum(counts)[:-1]][rb]
    cb = np.zeros((r, max(int(counts.max(initial=0)), 1)), np.int32)
    cb[rb, slot] = block_ids % ncb
    if not nonzero:
        return cb, None
    sums = np.zeros(entries.shape[0], np_dtype)
    np.add.at(sums, inv.reshape(-1), vals.astype(np_dtype, copy=False))
    if bf16:  # a bfloat16 word without its sign
        magnitude = torch.from_numpy(sums).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16) & 0x7FFF
    else:
        magnitude = np.abs(sums)
    mask = np.zeros(cb.shape, bool)
    if first.size:
        mask[rb, slot] = np.maximum.reduceat(magnitude, first) > 0
    return cb, mask


class ShardedBSROperator(ShardedOperator):
    """BSR operator row-partitioned over a :class:`RowMesh`: this rank holds
    its slab of ``R / size`` row blocks in the canonical ``rsmk`` layout.

    ``comm`` names the halo schedule of :meth:`matvec`:

    * ``'gather'``: all-gather the input, then one local SpMV of the slab
      against the whole vector (n words per rank and matvec, whatever the
      pattern);
    * ``'ring'``: the tiles are split at pack time into self, left and right
      owner groups with local column ids; the two neighbour exchanges are
      started before the self-group SpMV, which they overlap.  Valid only
      when every tile's column owner is within one hop of its row owner;
    * ``'footprint'``: for every owner hop that occurs, the column blocks
      this rank's tiles touch on that owner are recorded at pack time; per
      matvec each rank selects the blocks its receivers need
      (``index_select``) and one exchange per hop delivers them, the self
      group's SpMV running meanwhile.  ``footprint_words`` is the words each
      rank receives per matvec, ``sum_h F_h * bk``.

    ``use_pallas`` is kept for the JAX signature only: on CUDA the local
    SpMV of every group is kernel K2 whatever its value, on the CPU the
    plain version.  Build it with :meth:`from_coo`; a group is
    ``(tiles, col_blocks, col_bound)`` with ``col_bound`` one more than the
    largest column id, which K2's wrapper checks against its x table.
    """

    def __init__(self, blocks, col_blocks, n: int, mesh: RowMesh, use_pallas: bool = False, comm: str = "gather",
                 ring_groups=None, footprint=None, footprint_words: int = 0):
        self.blocks = blocks  # (R_local, S, bm, bk), this rank's row blocks
        self.col_blocks = col_blocks  # (R_local, S) int32, global column-block ids
        self.n = int(n)
        self.mesh = mesh
        self.use_pallas = bool(use_pallas)
        self.comm = comm
        self.ring_groups = ring_groups  # (self, left, right) groups
        self.footprint = footprint  # (self group, ((hop, group, send_idx), ...))
        self.footprint_words = int(footprint_words)
        self.n_padded = blocks.shape[0] * blocks.shape[2] * mesh.size
        self._col_bound = int(col_blocks.max()) + 1 if col_blocks.numel() else 0

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def bm(self) -> int:
        return self.blocks.shape[2]

    @property
    def bk(self) -> int:
        return self.blocks.shape[3]

    @classmethod
    def from_coo(cls, rows, cols, vals, n: int, mesh: RowMesh, *, bm: int = 128, bk: int = 128, dtype=torch.float32,
                 use_pallas: bool = False, comm: str = "gather"):
        """Pack this rank's row blocks of the COO triplets (duplicates
        summed); bfloat16 tiles are packed in float32 and rounded once, as
        :meth:`BSROperator.from_coo` packs them.  Every rank holds the whole
        COO but packs only its own rows: the other ranks' tiles enter only
        as the pattern (their column blocks and which of them hold a
        nonzero), which the schedules read.

        n is padded so that the row blocks split evenly over the ranks and
        each slab is a whole number of column blocks: ``q = lcm(lcm(bk,
        size*bm), size*bk)``, as the JAX package pads.  ``comm='auto'`` takes
        ring when the pattern allows it, else footprint when it moves at most
        a quarter of the gather's words, else gather; an explicit
        ``'footprint'`` falls back to gather only when it saves nothing, and
        an explicit ``'ring'`` raises ``ValueError`` on a tile more than one
        hop away.  On one rank every mode is ``'gather'``.
        """
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        np_dtype = pack_dtype(dtype)
        bf16 = is_bfloat16(dtype)
        if np.iscomplexobj(vals) and not np.issubdtype(np_dtype, np.complexfloating):
            raise TypeError(f"complex values with real block dtype {dtype} would silently drop the imaginary parts")
        ndev = mesh.size
        q = int(np.lcm(np.lcm(bk, ndev * bm), ndev * bk))
        n_pad = -(-max(int(n), 1) // q) * q
        cb = nonzero = s = None
        if ndev > 1:  # every rank's tiles have the global S
            cb, nonzero = _tile_pattern(rows, cols, vals, n_pad, bm, bk, np_dtype, bf16, nonzero=comm != "gather")
            s = cb.shape[1]
        lo, hi = mesh.rank * (n_pad // ndev), (mesh.rank + 1) * (n_pad // ndev)
        mine = (rows >= lo) & (rows < hi)  # keeps the input order: duplicates sum as in the whole pack
        tiles, cb_mine = _pack_bsr(rows[mine] - lo, cols[mine], vals[mine], hi - lo, bm, bk, np_dtype, layout="rsmk",
                                   n_cols=n_pad, s=s)
        if bf16:
            tiles = torch.from_numpy(tiles).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
        return cls._from_slab(tiles, cb_mine if cb is None else cb, nonzero, n, mesh, use_pallas, comm)

    @classmethod
    def from_blocks(cls, blocks, col_blocks, n: int, mesh: RowMesh, *, use_pallas: bool = False,
                    comm: str = "gather"):
        """This rank's operator from the global packed arrays: ``blocks``
        (R, S, bm, bk) in the ``rsmk`` layout and ``col_blocks`` (R, S), R*bm
        padded as :meth:`from_coo` pads it (numpy arrays, the JAX package's
        ``ShardedBSROperator`` holds the same, or CPU tensors).  ``comm`` as
        in :meth:`from_coo`.  bfloat16 tiles (a tensor, or numpy's
        ``ml_dtypes`` array of a JAX operator) are regrouped as their 16-bit
        words and keep their bits."""
        bf16 = is_bfloat16(getattr(blocks, "dtype", None))
        if isinstance(blocks, torch.Tensor):
            blocks = (blocks.view(torch.int16) if bf16 else blocks).numpy()
        blocks = np.asarray(blocks).view(np.uint16) if bf16 else np.asarray(blocks)
        cb = np.asarray(col_blocks, dtype=np.int32)
        r, s, bm, bk = blocks.shape
        ndev, rank = mesh.size, mesh.rank
        n_pad = r * bm
        if cb.shape != (r, s) or n_pad % bk or r % ndev or (n_pad // bk) % ndev or n_pad < n:
            raise ValueError(f"tiles {blocks.shape} / col_blocks {cb.shape} do not split into {ndev} row slabs "
                             f"of whole column blocks holding n={n}")
        nonzero = None
        if ndev > 1 and comm != "gather":
            magnitude = blocks & 0x7FFF if bf16 else np.abs(blocks)  # a bfloat16 word without its sign
            nonzero = magnitude.reshape(r, s, -1).max(axis=-1) > 0
        rpd = r // ndev
        return cls._from_slab(blocks[rank * rpd:(rank + 1) * rpd], cb, nonzero, n, mesh, use_pallas, comm)

    @classmethod
    def _from_slab(cls, tiles, cb, nonzero, n: int, mesh: RowMesh, use_pallas: bool, comm: str):
        """This rank's operator from its own tiles (rpd, S, bm, bk) (bfloat16
        as uint16 words) and the global pattern: ``cb`` (R, S) and
        ``nonzero`` (R, S), which only the ring and footprint schedules
        read (None under gather or on one rank)."""
        if comm not in ("gather", "ring", "footprint", "auto"):
            raise ValueError("comm must be 'gather', 'ring', 'footprint' or 'auto'")
        r = cb.shape[0]
        bm, bk = tiles.shape[2], tiles.shape[3]
        ndev, rank = mesh.size, mesh.rank
        n_pad = r * bm
        requested = comm
        rpd = r // ndev  # row blocks per rank
        cpd = (n_pad // bk) // ndev  # column blocks per rank
        mine = slice(rank * rpd, (rank + 1) * rpd)
        ring_groups = footprint = None
        words = 0
        if ndev > 1 and comm != "gather":
            hop = cb // cpd - (np.arange(r) // rpd)[:, None]  # owner hop of every tile
        if comm in ("ring", "auto") and ndev > 1:
            if np.any(nonzero & (np.abs(hop) > 1)):
                if comm == "ring":
                    raise ValueError("ring comm needs every tile within one ring hop of its row owner; "
                                     "use comm='gather' for scattered patterns")
                comm = "footprint"  # the auto ladder: ring > footprint > gather
            else:
                ring_groups = tuple(
                    cls._group(mesh, *_tile_group(tiles, cb[mine], (nonzero & (hop == h))[mine],
                                                  lambda i, j, h=h: cb[mine][i, j] - (rank + h) * cpd, bm, bk))
                    for h in (0, -1, 1)
                )
                comm = "ring"
        if comm == "footprint" and ndev > 1:
            footprint, words = cls._pack_footprint(mesh, tiles, cb, nonzero, hop, rpd, cpd, bm, bk)
            # Each hop costs one exchange and one grouped SpMV, so auto takes
            # the footprint only for a >= 4x cut of the gather's words; an
            # explicit request falls back only when it saves nothing.
            if words >= (n_pad // 4 if requested == "auto" else n_pad):
                footprint, comm, words = None, "gather", 0
        if ndev <= 1 or comm not in ("ring", "footprint"):
            comm, ring_groups, footprint, words = "gather", None, None, 0
        dev = mesh.device
        return cls(_tiles_tensor(tiles, dev), torch.from_numpy(np.ascontiguousarray(cb[mine])).to(dev),
                   int(n), mesh, use_pallas, comm, ring_groups, footprint, words)

    @staticmethod
    def _group(mesh, tiles, cbg):
        bound = int(cbg.max(initial=0)) + 1
        return _tiles_tensor(tiles, mesh.device), torch.from_numpy(cbg).to(mesh.device), bound

    @classmethod
    def _pack_footprint(cls, mesh, tiles, cb, nonzero, hop, rpd, cpd, bm, bk):
        """The footprint schedule of this rank: its self group (local column
        ids) and, for every hop h != 0 that occurs anywhere, the tiles of its
        rows owned by rank + h (column ids into the received payload) and
        the sender-local blocks it ships to rank - h.  Payloads are padded to
        F_h, the most blocks any rank receives on that hop, so every rank
        computes the same words ``sum_h F_h * bk``."""
        ndev, rank = mesh.size, mesh.rank
        mine = slice(rank * rpd, (rank + 1) * rpd)
        cb_m = cb[mine]
        self_group = cls._group(mesh, *_tile_group(tiles, cb_m, (nonzero & (hop == 0))[mine],
                                                   lambda i, j: cb_m[i, j] - rank * cpd, bm, bk))
        hops = []
        words = 0
        for h in sorted({int(v) for v in np.unique(hop[nonzero]) if v != 0}):
            sel = nonzero & (hop == h)
            need = [np.unique(cb[d * rpd:(d + 1) * rpd][sel[d * rpd:(d + 1) * rpd]]) for d in range(ndev)]
            f_h = max(max(len(ids) for ids in need), 1)
            mine_need = need[rank]
            group = cls._group(mesh, *_tile_group(tiles, cb_m, sel[mine],
                                                  lambda i, j: np.searchsorted(mine_need, cb_m[i, j]), bm, bk))
            send = np.zeros(f_h, np.int64)
            d = rank - h  # the receiver of this rank's payload on hop h
            if 0 <= d < ndev:
                send[: len(need[d])] = need[d] - rank * cpd
            hops.append((h, group, torch.from_numpy(send).to(mesh.device)))
            words += f_h * bk
        return (self_group, tuple(hops)), words

    def _spmv(self, group, xtab):
        tiles, cbg, bound = group
        return spmv.bsr_matvec_rsmk(tiles, cbg, xtab, col_bound=bound)

    def abs_row_sums(self):
        # The rsmk tiles (R, S, bm, bk) over (S, bk), this rank's real rows;
        # bfloat16 tiles are summed in float32.
        return self._real_rows(self.blocks.abs().sum(dim=(1, 3), dtype=_sum_dtype(self.dtype)).reshape(-1))

    def start_halo(self, x):
        """Start the ring's or the footprint's exchange of this rank's slab
        ``x``: ``(works, buffers)``, the received payloads once the works
        are waited on (the ring's left and right slabs; one a hop for the
        footprint).  The edge ranks' missing peers leave zeros."""
        rank = self.mesh.rank
        if self.comm == "ring":
            from_left, from_right = torch.zeros_like(x), torch.zeros_like(x)
            return _exchange(self.mesh, [(x, rank + 1, 0), (x, rank - 1, 1)],
                             [(from_left, rank - 1, 0), (from_right, rank + 1, 1)]), (from_left, from_right)
        hops = self.footprint[1]
        x2 = x.view(-1, self.bk)
        # hop t: ship the blocks rank - h needs from this rank, receive those
        # this rank needs from rank + h (tag t)
        recvs = [torch.zeros((send.shape[0], self.bk), dtype=x.dtype, device=x.device) for _h, _g, send in hops]
        return _exchange(self.mesh, [(x2.index_select(0, send), rank - h, t) for t, (h, _g, send) in enumerate(hops)],
                         [(buf, rank + h, t) for t, (buf, (h, _g, _s)) in enumerate(zip(recvs, hops))]), recvs

    def matvec(self, x):
        """``A x`` on slabs: this rank's rows of A times the global x, from
        this rank's slab ``x`` of ``n_local`` rows."""
        self._check_slab(x)
        if self.comm not in ("ring", "footprint"):
            return self._spmv((self.blocks, self.col_blocks, self._col_bound), all_gather(x, self.mesh))
        # The exchange starts before the self-group SpMV it overlaps; the
        # edge ranks' all-zero edge groups multiply the zeros they keep.
        works, bufs = self.start_halo(x)
        own, groups = (self.ring_groups[0], self.ring_groups[1:]) if self.comm == "ring" else (
            self.footprint[0], [group for _h, group, _s in self.footprint[1]])
        y = self._spmv(own, x)
        _wait(works)
        for buf, group in zip(bufs, groups):
            y = y + self._spmv(group, buf)
        return y


class ShardedDIAOperator(ShardedOperator):
    """Banded operator row-partitioned over a :class:`RowMesh`, with halos:
    each rank holds its columns of every stored diagonal and exchanges
    ``halo = max|offset|`` boundary values with each neighbour per matvec.
    The ranks at the ends receive nothing and keep zeros, the out-of-range
    semantics of :class:`~lanczos_tpu_torch.ops.operators.DIAOperator`.
    Needs ``n % size == 0`` and ``halo <= n / size``."""

    def __init__(self, offsets, data, n: int, mesh: RowMesh):
        self.offsets = tuple(int(o) for o in offsets)
        self.data = data  # (ndiag, n_local), this rank's columns
        self.n = int(n)
        self.n_padded = self.n
        self.mesh = mesh

    @classmethod
    def from_diagonals(cls, offsets, diagonals, n: int, mesh: RowMesh, *, dtype=None):
        """``diagonals[d]`` is the length-n array with ``A[i, i + offsets[d]]``
        at position i, as in ``DIAOperator.from_diagonals``."""
        ndev = mesh.size
        if n % ndev != 0:
            raise ValueError(f"mesh size {ndev} must divide n={n} evenly (pad the operator)")
        base = DIAOperator.from_diagonals(offsets, diagonals, n, dtype=dtype, device="cpu")
        halo = max((abs(o) for o in base.offsets), default=0)
        nl = n // ndev
        if halo > nl:
            raise ValueError(f"halo {halo} exceeds the local shard {nl}")
        data = base.data[:, mesh.rank * nl:(mesh.rank + 1) * nl].contiguous()
        return cls(base.offsets, data.to(mesh.device), n, mesh)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def halo(self) -> int:
        return max((abs(o) for o in self.offsets), default=0)

    def abs_row_sums(self):
        return dia_abs_row_sums(self.data, self.dtype)

    def matvec(self, x):
        self._check_slab(x)
        w, nl, rank = self.halo, self.n_local, self.mesh.rank
        x_ext = x
        if w > 0:
            left = torch.zeros(w, dtype=x.dtype, device=x.device)
            right = torch.zeros(w, dtype=x.dtype, device=x.device)
            # rank j's last w values are rank j+1's left halo (tag 0), its
            # first w rank j-1's right halo (tag 1)
            _wait(_exchange(self.mesh, [(x[-w:], rank + 1, 0), (x[:w], rank - 1, 1)],
                            [(left, rank - 1, 0), (right, rank + 1, 1)]))
            x_ext = torch.cat([left, x, right])
        y = torch.zeros_like(x)
        for j, d in enumerate(self.offsets):
            y = y + self.data[j].to(x.dtype) * x_ext[w + d:w + d + nl]
        return y


class ShardedDenseOperator(ShardedOperator):
    """Dense operator split into row slabs: this rank holds rows
    ``[rank * n_local, (rank + 1) * n_local)`` (zero rows past n) and
    all-gathers the input of every matvec (the JAX package's
    ``P('rows', None)`` placement, whose gather GSPMD inserts)."""

    def __init__(self, a_local, n: int, mesh: RowMesh):
        self.a = a_local  # (n_local, n)
        self.n = int(n)
        self.n_padded = a_local.shape[0] * mesh.size
        self.mesh = mesh

    @classmethod
    def from_dense(cls, a, mesh: RowMesh):
        a = torch.as_tensor(a)
        n = a.shape[0]
        nl = -(-n // mesh.size)
        lo, hi = min(mesh.rank * nl, n), min((mesh.rank + 1) * nl, n)
        a_local = torch.zeros((nl, n), dtype=a.dtype)
        a_local[: hi - lo] = a[lo:hi].cpu()
        return cls(a_local.to(mesh.device), n, mesh)

    @property
    def dtype(self):
        return self.a.dtype

    def abs_row_sums(self):
        return self._real_rows(self.a.abs().sum(dim=1))

    def matvec(self, x):
        self._check_slab(x)
        return self.a.to(x.dtype) @ all_gather(x, self.mesh)[: self.n]


class ShardedDenseOperator2D(ShardedOperator):
    """Dense operator split over a ``(rows, cols)`` grid (a
    :class:`~lanczos_tpu_torch.parallel.mesh.GridMesh` whose first axis
    indexes the row blocks ``I_i`` and whose second the column blocks
    ``J_j``; n is zero-padded to a multiple of both): rank ``(i, j)`` holds
    the block ``A[I_i, J_j]``.

    Vectors are row slabs over the ``rows`` axis and the same on every rank
    of a row of the grid: ``mesh`` is ``grid.slices_mesh``, the ranks
    ``(., j)``, so ``group`` is a column of the grid and the engines run
    unchanged over it, each column running an identical replica of them.
    :meth:`matvec` all-gathers the input over that column, cuts ``x[J_j]``,
    forms the partial product ``A[I_i, J_j] x[J_j]`` and sums the partials
    over the ranks ``(i, .)``, ``grid.rows_mesh`` (the JAX package's partial
    sum over ``cols``)."""

    def __init__(self, a_local, n: int, grid: GridMesh):
        self.a = a_local  # (n_padded / rows, n_padded / cols), the block A[I_i, J_j]
        self.n = int(n)
        self.grid = grid
        self.mesh = grid.slices_mesh  # the ranks (., j): the vector's slabs
        self.n_padded = a_local.shape[0] * self.mesh.size

    @classmethod
    def from_dense(cls, a, grid: GridMesh):
        a = torch.as_tensor(a)
        n = a.shape[0]
        q = int(np.lcm(*grid.shape))
        n_pad = -(-n // q) * q
        nr, nc = n_pad // grid.shape[0], n_pad // grid.shape[1]
        i, j = grid.coords
        r0, r1, c0, c1 = min(i * nr, n), min((i + 1) * nr, n), min(j * nc, n), min((j + 1) * nc, n)
        block = torch.zeros((nr, nc), dtype=a.dtype, device=grid.world.device)
        block[: r1 - r0, : c1 - c0] = a[r0:r1, c0:c1]
        return cls(block, n, grid)

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def draw_group(self):
        """Every rank of the grid: each column's replica of the engines
        draws the vectors the other columns draw."""
        return self.grid.world.group

    def abs_row_sums(self):
        return self._real_rows(reduce_sum(self.a.abs().sum(dim=1), self.grid.rows_mesh.group))

    def matvec(self, x):
        self._check_slab(x)
        nc = self.a.shape[1]
        j = self.grid.coords[1]
        x_j = all_gather(x, self.mesh)[j * nc:(j + 1) * nc]
        return reduce_sum(self.a.to(x.dtype) @ x_j, self.grid.rows_mesh.group)


def shard_operator(op: LinearOperator, mesh: RowMesh) -> LinearOperator:
    """Row-partition an operator over ``mesh``: a dense operator becomes a
    :class:`ShardedDenseOperator`, a :class:`ShardedBSROperator` is returned
    as it is; anything else raises ``TypeError`` (BSR operators are built
    with :meth:`ShardedBSROperator.from_coo`, whose padding follows the
    mesh)."""
    if isinstance(op, DenseOperator):
        return ShardedDenseOperator.from_dense(op.a, mesh)
    if isinstance(op, ShardedBSROperator):
        return op
    raise TypeError(f"cannot auto-shard {type(op).__name__}; use ShardedBSROperator.from_coo for sparse operators")
