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
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core.types import to_numpy_dtype
from ..ops import spmv
from ..ops.operators import DenseOperator, DIAOperator, LinearOperator, _pack_bsr
from .mesh import RowMesh, all_gather, gather_vector, shard_vector

__all__ = [
    "ShardedOperator",
    "ShardedBSROperator",
    "ShardedDIAOperator",
    "ShardedDenseOperator",
    "shard_operator",
    "refuse_sharded",
]

_DF_ITEM = "ROADMAP.md, 'Modules to port', item 10: precise paths on native float64"
_ENGINE_ITEM = ("ROADMAP.md, 'Modules to port', item 13: the thick, block, filtered and precise "
                "engines over sharded operators")


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

    def matvec_df(self, x_hi, x_lo):
        raise NotImplementedError(f"the double-float sharded matvec is not ported; see {_DF_ITEM}")

    def _check_slab(self, x):
        if x.shape != (self.n_local,):
            raise ValueError(f"matvec takes this rank's slab of {self.n_local} rows, got shape {tuple(x.shape)}")


def refuse_sharded(op, what: str) -> None:
    """Raise ``NotImplementedError`` when ``op`` is row-partitioned: the
    engine ``what`` is ported for operators on one device only."""
    if isinstance(op, ShardedOperator):
        raise NotImplementedError(f"{what} over a sharded operator is not ported; see {_ENGINE_ITEM}")


def _exchange(mesh: RowMesh, sends, recvs):
    """Start the point-to-point transfers ``sends`` and ``recvs``, lists of
    ``(tensor, peer rank in the mesh, tag)``, together; returns the works to
    wait on.  Peers outside the mesh are skipped, so a receive buffer whose
    sender does not exist keeps its zeros."""
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
        """Pack COO triplets (duplicates summed) and keep this rank's slab.

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
        np_dtype = to_numpy_dtype(dtype)
        if np.iscomplexobj(vals) and not np.issubdtype(np_dtype, np.complexfloating):
            raise TypeError(f"complex values with real block dtype {np_dtype} would silently drop the imaginary parts")
        q = int(np.lcm(np.lcm(bk, mesh.size * bm), mesh.size * bk))
        n_pad = -(-max(int(n), 1) // q) * q
        blocks, cb = _pack_bsr(rows, cols, vals, n_pad, bm, bk, np_dtype, layout="rsmk")
        return cls.from_blocks(blocks, cb, n, mesh, use_pallas=use_pallas, comm=comm)

    @classmethod
    def from_blocks(cls, blocks, col_blocks, n: int, mesh: RowMesh, *, use_pallas: bool = False,
                    comm: str = "gather"):
        """This rank's operator from the global packed arrays: ``blocks``
        (R, S, bm, bk) in the ``rsmk`` layout and ``col_blocks`` (R, S), R*bm
        padded as :meth:`from_coo` pads it (numpy arrays; the JAX package's
        ``ShardedBSROperator`` holds the same).  ``comm`` as in
        :meth:`from_coo`."""
        if comm not in ("gather", "ring", "footprint", "auto"):
            raise ValueError("comm must be 'gather', 'ring', 'footprint' or 'auto'")
        blocks = np.asarray(blocks)
        cb = np.asarray(col_blocks, dtype=np.int32)
        r, s, bm, bk = blocks.shape
        ndev, rank = mesh.size, mesh.rank
        n_pad = r * bm
        if cb.shape != (r, s) or n_pad % bk or r % ndev or (n_pad // bk) % ndev or n_pad < n:
            raise ValueError(f"tiles {blocks.shape} / col_blocks {cb.shape} do not split into {ndev} row slabs "
                             f"of whole column blocks holding n={n}")
        requested = comm
        rpd = r // ndev  # row blocks per rank
        cpd = (n_pad // bk) // ndev  # column blocks per rank
        mine = slice(rank * rpd, (rank + 1) * rpd)
        ring_groups = footprint = None
        words = 0
        if ndev > 1 and comm != "gather":
            nonzero = np.abs(blocks).reshape(r, s, -1).max(axis=-1) > 0
            hop = cb // cpd - (np.arange(r) // rpd)[:, None]  # owner hop of every tile
        if comm in ("ring", "auto") and ndev > 1:
            if np.any(nonzero & (np.abs(hop) > 1)):
                if comm == "ring":
                    raise ValueError("ring comm needs every tile within one ring hop of its row owner; "
                                     "use comm='gather' for scattered patterns")
                comm = "footprint"  # the auto ladder: ring > footprint > gather
            else:
                ring_groups = tuple(
                    cls._group(mesh, *_tile_group(blocks[mine], cb[mine], (nonzero & (hop == h))[mine],
                                                  lambda i, j, h=h: cb[mine][i, j] - (rank + h) * cpd, bm, bk))
                    for h in (0, -1, 1)
                )
                comm = "ring"
        if comm == "footprint" and ndev > 1:
            footprint, words = cls._pack_footprint(mesh, blocks, cb, nonzero, hop, rpd, cpd, bm, bk)
            # Each hop costs one exchange and one grouped SpMV, so auto takes
            # the footprint only for a >= 4x cut of the gather's words; an
            # explicit request falls back only when it saves nothing.
            if words >= (n_pad // 4 if requested == "auto" else n_pad):
                footprint, comm, words = None, "gather", 0
        if ndev <= 1 or comm not in ("ring", "footprint"):
            comm, ring_groups, footprint, words = "gather", None, None, 0
        dev = mesh.device
        return cls(torch.from_numpy(np.ascontiguousarray(blocks[mine])).to(dev),
                   torch.from_numpy(np.ascontiguousarray(cb[mine])).to(dev),
                   int(n), mesh, use_pallas, comm, ring_groups, footprint, words)

    @staticmethod
    def _group(mesh, tiles, cbg):
        bound = int(cbg.max(initial=0)) + 1
        return torch.from_numpy(tiles).to(mesh.device), torch.from_numpy(cbg).to(mesh.device), bound

    @classmethod
    def _pack_footprint(cls, mesh, blocks, cb, nonzero, hop, rpd, cpd, bm, bk):
        """The footprint schedule of this rank: its self group (local column
        ids) and, for every hop h != 0 that occurs anywhere, the tiles of its
        rows owned by rank + h (column ids into the received payload) and
        the sender-local blocks it ships to rank - h.  Payloads are padded to
        F_h, the most blocks any rank receives on that hop, so every rank
        computes the same words ``sum_h F_h * bk``."""
        ndev, rank = mesh.size, mesh.rank
        mine = slice(rank * rpd, (rank + 1) * rpd)
        blk_m, cb_m = blocks[mine], cb[mine]
        self_group = cls._group(mesh, *_tile_group(blk_m, cb_m, (nonzero & (hop == 0))[mine],
                                                   lambda i, j: cb_m[i, j] - rank * cpd, bm, bk))
        hops = []
        words = 0
        for h in sorted({int(v) for v in np.unique(hop[nonzero]) if v != 0}):
            sel = nonzero & (hop == h)
            need = [np.unique(cb[d * rpd:(d + 1) * rpd][sel[d * rpd:(d + 1) * rpd]]) for d in range(ndev)]
            f_h = max(max(len(ids) for ids in need), 1)
            mine_need = need[rank]
            group = cls._group(mesh, *_tile_group(blk_m, cb_m, sel[mine],
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

    def matvec(self, x):
        """``A x`` on slabs: this rank's rows of A times the global x, from
        this rank's slab ``x`` of ``n_local`` rows."""
        self._check_slab(x)
        rank = self.mesh.rank
        if self.comm == "ring":
            own, left, right = self.ring_groups
            from_left, from_right = torch.zeros_like(x), torch.zeros_like(x)
            # Both exchanges start before the self-group SpMV they overlap;
            # the edge ranks keep zeros, which their all-zero edge groups
            # multiply.
            works = _exchange(self.mesh, [(x, rank + 1, 0), (x, rank - 1, 1)],
                              [(from_left, rank - 1, 0), (from_right, rank + 1, 1)])
            y = self._spmv(own, x)
            _wait(works)
            y = y + self._spmv(left, from_left)
            return y + self._spmv(right, from_right)
        if self.comm == "footprint":
            own, hops = self.footprint
            x2 = x.view(-1, self.bk)
            # hop t: ship the blocks rank - h needs from this rank, receive
            # those this rank needs from rank + h (tag t)
            recvs = [torch.zeros((send.shape[0], self.bk), dtype=x.dtype, device=x.device) for _h, _g, send in hops]
            works = _exchange(self.mesh,
                              [(x2.index_select(0, send), rank - h, t) for t, (h, _g, send) in enumerate(hops)],
                              [(buf, rank + h, t) for t, (buf, (h, _g, _s)) in enumerate(zip(recvs, hops))])
            y = self._spmv(own, x)
            _wait(works)
            for buf, (_h, group, _s) in zip(recvs, hops):
                y = y + self._spmv(group, buf)
            return y
        return self._spmv((self.blocks, self.col_blocks, self._col_bound), all_gather(x, self.mesh))


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

    def matvec(self, x):
        self._check_slab(x)
        return self.a @ all_gather(x, self.mesh)[: self.n]


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
