"""Sharded four-step (Bailey) NTT: one exchange per transform
(counterpart of ``stark_rings_tpu/parallel/ntt.py``).

Degree-N (nega)cyclic NTT as an N1 x N2 matrix (n = n1*N2 + n2):

    1. (negacyclic only) twist      x *= psi^n                   per shard
    2. column NTTs of size N1       (cyclic, leaf order)         per shard
    3. twiddle  *= omega^(k1 * n2)                               per shard
    4. transpose [N1, N2/P] -> [N1/P, N2]      = ONE exchange
    5. row NTTs of size N2          (cyclic, leaf order)         per shard

The inverse runs the mirror.  Outputs stay in the reference's product
order (column leaf x row leaf), so pointwise products are exact and no
bit reversal moves data.

Sharded data is a list of P shard tensors on a :class:`~.mesh.Mesh`:
coefficients column-sharded, shard p = columns [p*C, (p+1)*C) of the
[..., N1, N2] matrix ([..., N1, C], C = N2/P); evaluations row-sharded,
shard p = rows [p*R, (p+1)*R) ([..., R, N2], R = N1/P).
:meth:`ShardedNTT.shard` and :meth:`ShardedNTT.gather` move the
reference's numpy storage in and out, as ``jax.device_put`` with a
``NamedSharding`` and ``np.asarray`` do there.

Steps 3-4 are the exchange: ``exchange="xla"`` multiplies by the
twiddle and runs the plain block transpose (torch slicing, ``cat`` and
``.to(device)``: the reference's ``jax.lax.all_to_all``);
``exchange="pallas"`` runs K8 (:mod:`.exchange`), one launch per
exchange on CUDA shards of one card.  The local transforms
(``local="vpu"``) are the radix kernels for Goldilocks: a cyclic
:class:`~..ops.goldilocks_ntt.GoldilocksKernelNTT` of size N1 or N2, one
``ntt_tile`` launch over all the rows of a shard for N1, N2 <= 2^13
(the column transform on the shard viewed as [B*C, N1] rows: one
transpose copy in, one out).  The other fields have no radix kernel in
either package and run the plain radix ``NTTContext``, once per shard.
``local="mxu"`` (Goldilocks) runs the digit-GEMM ``PrescaledMat``.  All
give ``NTTContext(negacyclic=False)``'s bits, as the reference's XLA
locals do.  The Goldilocks twist, twiddle and slot products are the
``pointwise_mul`` kernel (the tables broadcast over the batch).  The
twiddle tables are built on the host and cached per (shard, device);
the reference builds them on its device by log-doubling.  The values
are equal.  The 8-limb stark_prime storage carries its limb axis last
([..., N1, N2, 8]); its exchange is the plain block transpose (the
reference keeps the XLA collective there too, not K8), and its twist,
twiddle and slot products are kernel S1 on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import get_device
from ..fields import get_field
from ..ops.fold import pointwise_mul
from ..ops.goldilocks_ntt import GoldilocksKernelNTT
from ..ops.mxu2 import PrescaledMat, digit_table
from ..ops.ntt import NTTContext, find_primitive_root
from .exchange import (EXCHANGE_FIELDS, all_to_all, twiddle_exchange_fwd,
                       twiddle_exchange_inv)
from .mesh import check_shards, gather, shard, with_index

__all__ = ["ShardedNTT"]


def _pow_table(f, base: int, n: int) -> torch.Tensor:
    """[base^0 .. base^(n-1)] in storage form on the CPU, by doubling."""
    tab = f.encode([1, base], "cpu")
    while tab.shape[0] < n:
        step = f.const(pow(base, tab.shape[0], f.q), "cpu")
        tab = torch.cat([tab, f.mul(tab, step)])
    return tab[:n]


class ShardedNTT:
    """The four-step NTT of degree N over P shards.

    ``device`` is where :meth:`make_single_chip_fns` runs
    (``single_chip=True``, P = 1): its tables are placed there and its
    functions take tensors on that device only.  It is the card unless
    the caller passes ``device="cpu"``.  The mesh functions run on their
    mesh's devices."""

    def __init__(self, field_name: str, N: int, n_devices: int,
                 negacyclic: bool = True, axis: str = "x",
                 local: str = "vpu", exchange: str = "xla",
                 single_chip: bool = False, device="cuda"):
        f = get_field(field_name)
        if N < 4 or N & (N - 1):
            raise ValueError(f"N={N} must be a power of two >= 4")
        logN = N.bit_length() - 1
        N1 = 1 << (logN // 2)
        N2 = N // N1
        Pn = n_devices
        if Pn < 1 or N1 % Pn or N2 % Pn:
            raise ValueError(f"P={Pn} must divide N1={N1} and N2={N2}")
        if (f.q - 1) % (2 * N):
            raise ValueError(f"{f.name}: 2N={2 * N} must divide q-1")
        if local not in ("vpu", "mxu"):
            raise ValueError(f"local must be 'vpu' or 'mxu', got {local!r}")
        if local == "mxu" and field_name != "goldilocks":
            raise ValueError("mxu local transforms are goldilocks-only")
        if exchange not in ("xla", "pallas"):
            raise ValueError(f"exchange must be 'xla' or 'pallas', got "
                             f"{exchange!r}")
        if exchange == "pallas" and field_name not in EXCHANGE_FIELDS:
            raise ValueError(f"the pallas exchange (K8) runs over "
                             f"{list(EXCHANGE_FIELDS)}, not {field_name!r}")
        if single_chip and Pn != 1:
            raise ValueError("single_chip needs P == 1")
        self.f = f
        self.N, self.N1, self.N2, self.P = N, N1, N2, Pn
        self.axis = axis
        self.negacyclic = negacyclic
        self.local = local
        self.exchange = exchange
        self.single_chip = bool(single_chip)
        self.device = with_index(get_device(device)) if single_chip else None
        g = find_primitive_root(f.q)
        self.psi_int = pow(g, (f.q - 1) // (2 * N), f.q)
        self.omega_int = pow(self.psi_int, 2, f.q)
        col_leaf = NTTContext(f, N1, negacyclic=False, device="cpu").leaf_exps
        self.k1_leaf = torch.tensor([e // 2 for e in col_leaf],
                                    dtype=torch.int64)
        self._consts = None
        self._ctxs = {}       # (size, device) -> the local engine
        self._tabs = {}       # (shard, device) -> its twiddle tables
        self._mxu_dev = {}    # device -> the digit tables
        if local == "mxu":
            self._mxu_mats = self._build_mxu_locals()

    # -- constant tables ----------------------------------------------------
    def consts(self):
        """(omega_pows [N], omega_inv_pows [N], (colt [N1], rowt [N2]),
        (icolt, irowt)) as CPU storage tensors, built once; the pairs are
        None when cyclic.  The reference's ``consts``, the same values."""
        if self._consts is None:
            f, N, q = self.f, self.N, self.f.q
            om = _pow_table(f, self.omega_int, N)
            omi = _pow_table(f, pow(self.omega_int, q - 2, q), N)
            tw = itw = None
            if self.negacyclic:
                rows = torch.arange(self.N1) * self.N2 % (2 * N)
                cols = torch.arange(self.N2)
                psi = _pow_table(f, self.psi_int, 2 * N)
                ipsi = _pow_table(f, pow(self.psi_int, q - 2, q), 2 * N)
                tw = (psi[rows], psi[cols])
                itw = (ipsi[rows], ipsi[cols])
            self._consts = (om, omi, tw, itw)
        return self._consts

    def _tables(self, p: int, device) -> dict:
        """Shard p's tables on ``device``: the twist ``tfac`` and untwist
        ``itfac`` [N1, C], the forward twiddles ``T`` [N1, C] and the
        inverse ones ``Ti`` [R, N2]."""
        key = (p, str(device))
        if key not in self._tabs:
            f = self.f
            om, omi, tw, itw = self.consts()
            C, R = self.N2 // self.P, self.N1 // self.P
            cols = p * C + torch.arange(C)
            k1 = self.k1_leaf
            tabs = {"T": om[k1[:, None] * cols[None, :] % self.N],
                    "Ti": omi[k1[p * R:(p + 1) * R, None]
                              * torch.arange(self.N2)[None, :] % self.N]}
            if self.negacyclic:
                tabs["tfac"] = f.mul(tw[0][:, None], tw[1][cols][None, :])
                tabs["itfac"] = f.mul(itw[0][:, None], itw[1][cols][None, :])
            self._tabs[key] = {k: v.to(device) for k, v in tabs.items()}
        return self._tabs[key]

    def _ctx(self, n: int, device):
        """The cyclic radix engine of size n on ``device``: the kernels'
        ``GoldilocksKernelNTT`` for Goldilocks, else ``NTTContext``."""
        key = (n, str(device))
        if key not in self._ctxs:
            if self.f.name == "goldilocks":
                eng = GoldilocksKernelNTT(n, device=device, negacyclic=False)
            else:
                eng = NTTContext(self.f, n, negacyclic=False, device=device)
            self._ctxs[key] = eng
        return self._ctxs[key]

    def _mul(self, a, b):
        """a * b, b of a's shape or broadcast over its leading axes: the
        ``pointwise_mul`` kernel for Goldilocks, the field's ``mul``
        (kernel S1 for stark_prime) else."""
        if self.f.name != "goldilocks":
            return self.f.mul(a, b)
        if a.numel() < b.numel():
            a, b = b, a
        return pointwise_mul(a.contiguous(), b.contiguous())

    def _build_mxu_locals(self):
        """Leaf-order cyclic NTT matrices for both local sizes, as
        :class:`PrescaledMat` digit planes: W[i, n] = w^(leaf[i]*n),
        Wi[n, i] = w^(-leaf[i]*n) / size.  Exact drop-ins for
        ``NTTContext.forward`` / ``inverse`` on the same leaf order."""
        q = self.f.q
        mats = {}
        for name, n in (("col", self.N1), ("row", self.N2)):
            w = pow(self.omega_int, self.N // n, q)
            wi = pow(w, q - 2, q)
            n_inv = pow(n, q - 2, q)
            leaf = np.array([e // 2 for e in NTTContext(
                self.f, n, negacyclic=False, device="cpu").leaf_exps])
            wpow = np.empty(n, dtype=object)
            wipow = np.empty(n, dtype=object)
            wpow[0] = wipow[0] = 1
            for j in range(1, n):
                wpow[j] = wpow[j - 1] * w % q
                wipow[j] = wipow[j - 1] * wi % q
            idx = leaf[:, None] * np.arange(n)[None, :] % n
            mats[name] = (PrescaledMat(np.take(wpow, idx)),
                          PrescaledMat(np.take(wipow, idx).T * n_inv % q))
        return mats

    def _mxu_apply(self, mat, w, corr):
        """``NTTContext.forward``/``inverse``-compatible last-axis map."""
        def fn(xm):
            n = xm.shape[-1]
            y = mat.fold(mat.dot(xm.reshape(-1, n).T, w, corr))
            return y.T.reshape(xm.shape[:-1] + (mat.R,))
        return fn

    def _local_fns(self, device):
        """(col_fwd, col_inv, row_fwd, row_inv) of the local engine."""
        if self.local == "mxu":
            key = str(device)
            if key not in self._mxu_dev:
                self._mxu_dev[key] = [
                    self._mxu_apply(m, *digit_table(m.big, device))
                    for name in ("col", "row") for m in self._mxu_mats[name]]
            return self._mxu_dev[key]
        col, row = self._ctx(self.N1, device), self._ctx(self.N2, device)
        return col.forward, col.inverse, row.forward, row.inverse

    # -- per-shard stages -----------------------------------------------------
    def _apply_on_axis(self, fn, x, axis_from_end: int):
        """Apply a coefficient-axis transform to an inner axis, counted
        from the end before the limb axis (which stays last)."""
        nd = len(self.f.limb_shape)
        ax, to = x.dim() - axis_from_end - nd, x.dim() - 1 - nd
        return fn(x.movedim(ax, to)).movedim(to, ax)

    def _pre_exchange(self, x, p: int):
        """Twist and column NTT of shard p's [..., N1, C] coefficients."""
        if self.negacyclic:
            x = self._mul(x, self._tables(p, x.device)["tfac"])
        return self._apply_on_axis(self._local_fns(x.device)[0], x, 2)

    def _pre_transpose(self, x, p: int):
        """Everything before the transpose: twist, column NTT, twiddle."""
        return self._mul(self._pre_exchange(x, p),
                         self._tables(p, x.device)["T"])

    def _rows(self, y):
        return self._apply_on_axis(self._local_fns(y.device)[2], y, 1)

    def _exchange_fwd(self, xs):
        """Twiddle and transpose of the P column shards."""
        tws = [self._tables(p, x.device)["T"] for p, x in enumerate(xs)]
        if self.single_chip:            # the P = 1 exchange is the identity
            return [self._mul(xs[0], tws[0])]
        if self.exchange == "pallas":
            return twiddle_exchange_fwd([x.contiguous() for x in xs], tws,
                                        self.f.name)
        nd = len(self.f.limb_shape)     # rows split, columns joined
        return all_to_all([self._mul(x, t) for x, t in zip(xs, tws)],
                          -2 - nd, -1 - nd)

    def _exchange_inv(self, ys):
        tws = [self._tables(p, y.device)["Ti"] for p, y in enumerate(ys)]
        if self.single_chip:
            return [self._mul(ys[0], tws[0])]
        if self.exchange == "pallas":
            return twiddle_exchange_inv([y.contiguous() for y in ys], tws,
                                        self.f.name)
        nd = len(self.f.limb_shape)
        return all_to_all([self._mul(y, t) for y, t in zip(ys, tws)],
                          -1 - nd, -2 - nd)

    def _local_forward(self, xs):
        """P shards [..., N1, C] -> P shards [..., N1/P, N2]."""
        ys = self._exchange_fwd([self._pre_exchange(x, p)
                                 for p, x in enumerate(xs)])
        return [self._rows(y) for y in ys]

    def _local_inverse(self, ys):
        """P shards [..., N1/P, N2] -> P shards [..., N1, C]."""
        xs = self._exchange_inv([self._apply_on_axis(
            self._local_fns(y.device)[3], y, 1) for y in ys])
        out = []
        for p, x in enumerate(xs):
            x = self._apply_on_axis(self._local_fns(x.device)[1], x, 2)
            if self.negacyclic:
                x = self._mul(x, self._tables(p, x.device)["itfac"])
            out.append(x)
        return out

    def _local_mul(self, fas, fbs):
        return [self._mul(a, b) for a, b in zip(fas, fbs)]

    # -- layouts ------------------------------------------------------------------
    def shard_specs(self, batch_ndim: int = 0):
        """(coeff_spec, eval_spec): per axis of [..., N1, N2(, L)], the
        mesh axis it is split over or None, as the reference's
        ``PartitionSpec``s."""
        lead = (None,) * batch_ndim
        limb = (None,) * len(self.f.limb_shape)
        return (lead + (None, self.axis) + limb,
                lead + (self.axis, None) + limb)

    def _split_axis(self, spec) -> int:
        return spec.index(self.axis) - len(spec)

    def shard(self, x, spec, mesh):
        """A [..., N1, N2] matrix (the reference's numpy storage, or a
        storage tensor) -> its P shards under ``spec``, shard p on
        ``mesh.devices[p]``."""
        self._check_mesh(mesh)
        return shard(x, mesh, self._split_axis(spec), self.f)

    def gather(self, shards, spec, device=None):
        """The shards under ``spec`` -> the whole matrix: the reference's
        numpy storage, or with ``device`` a storage tensor there."""
        return gather(shards, self._split_axis(spec), device)

    def to_matrix(self, coeffs):
        """[..., N(, L)] -> [..., N1, N2(, L)] (row-major n = n1*N2 + n2;
        a tensor or numpy array)."""
        limb = self.f.limb_shape
        lead = tuple(coeffs.shape[:len(coeffs.shape) - 1 - len(limb)])
        return coeffs.reshape(lead + (self.N1, self.N2) + limb)

    def from_matrix(self, m):
        """[..., N1, N2(, L)] -> [..., N(, L)] (a tensor or numpy array)."""
        limb = self.f.limb_shape
        lead = tuple(m.shape[:len(m.shape) - 2 - len(limb)])
        return m.reshape(lead + (self.N,) + limb)

    # -- entry points ---------------------------------------------------------
    def _check_mesh(self, mesh) -> None:
        if mesh.size != self.P:
            raise ValueError(f"mesh of {mesh.size} shards for P={self.P}")

    def _sharded(self, mesh, fn, n_in: int = 1):
        """``fn`` on lists of P shards, each list checked against the
        mesh (count, device, storage type)."""
        self._check_mesh(mesh)

        def call(*args):
            if len(args) != n_in:
                raise TypeError(f"expected {n_in} sharded operands")
            return fn(*[check_shards(mesh, a, self.f.dtype) for a in args])
        return call

    def make_fns(self, mesh, batch_ndim: int = 0,
                 overlap: bool | None = None):
        """(forward, inverse, mul) over the mesh's shards.

        forward: column shards [..., N1, C] -> row shards [..., N1/P, N2]
        (leaf-order evaluations); mul keeps the coefficient layout.
        ``overlap`` is taken for the reference's signature and changes
        nothing: the reference splits the batch so that XLA hides one
        chunk's all_to_all behind the next chunk's columns, and on one
        stream the chunks would only run in turn (ROADMAP queue 3,
        deliberate differences).  Its two forwards give the same bits."""
        self.consts()

        def local_mul(a, b):
            return self._local_inverse(self._local_mul(
                self._local_forward(a), self._local_forward(b)))

        return (self._sharded(mesh, self._local_forward),
                self._sharded(mesh, self._local_inverse),
                self._sharded(mesh, local_mul, 2))

    def make_cached_fns(self, mesh, batch_ndim: int = 0):
        """(precompute, mul_cached, square) over the mesh's shards.  A
        cached operand skips its forward transform and that transform's
        exchange; a batch-1 cached operand broadcasts over the live
        batch in the slot product."""
        self.consts()

        def mul_cached(a, fb):
            return self._local_inverse(self._local_mul(
                self._local_forward(a), fb))

        def square(a):
            fa = self._local_forward(a)
            return self._local_inverse(self._local_mul(fa, fa))

        return (self._sharded(mesh, self._local_forward),
                self._sharded(mesh, mul_cached, 2),
                self._sharded(mesh, square))

    def make_phase_fns(self, mesh, batch_ndim: int = 0):
        """The forward's three phases apart, for diagnosis: "pre" (twist,
        column NTT, twiddle; column shards stay column shards),
        "exchange" (the plain block transpose), "rows" (row NTT), and
        "forward" (all three, the production path)."""
        self.consts()

        def pre(xs):
            return [self._pre_transpose(x, p) for p, x in enumerate(xs)]

        nd = len(self.f.limb_shape)

        def exchange(ys):
            return all_to_all(ys, -2 - nd, -1 - nd)

        def rows(ys):
            return [self._rows(y) for y in ys]

        return {"pre": self._sharded(mesh, pre),
                "exchange": self._sharded(mesh, exchange),
                "rows": self._sharded(mesh, rows),
                "forward": self._sharded(mesh, self._local_forward)}

    def make_single_chip_fns(self):
        """(forward, inverse, mul) on whole [..., N1, N2] matrices (see
        :meth:`to_matrix`) on ``device``: the four-step on one device,
        P = 1, with no exchange.  Needs ``single_chip=True``."""
        if not self.single_chip:
            raise ValueError("construct with single_chip=True")
        dev = self.device
        self._tables(0, dev)
        self._local_fns(dev)

        def on_device(x):
            if x.device != dev:
                raise ValueError(f"the single-chip four-step runs on {dev}; "
                                 f"got a tensor on {x.device}")
            return [x]

        def forward(x):
            return self._local_forward(on_device(x))[0]

        def inverse(y):
            return self._local_inverse(on_device(y))[0]

        def mul(a, b):
            return inverse(self._mul(forward(a), forward(b)))

        return forward, inverse, mul
