"""Distributed EM count accumulation.

Port of historian_tpu/parallel/pcounts.py.  The reference scales `count`
as an offline file MapReduce: `historian count` per file, `historian sum`
to merge the JSON counts, `historian fit -counts` to re-estimate
(README.md:201-208).  Here the same count algebra runs across a device
mesh: alignment columns shard over the dp axis (and mixture components
over ep on a `DxE` mesh); each shard runs the port's Felsenstein up and
down passes and eigencount contraction (ops/felsenstein.py) on its own
device, the shards' partials are summed on the process's first mesh
device, and an all-reduce over the process group (parallel/dist.py)
takes the place of the JAX psum when the mesh spans processes.
`count|fit|sum|recon|mcmc -mesh N` (or HISTORIAN_MESH) turns it on.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from historian_tpu_torch import device as devmod
from historian_tpu_torch.models.counts import EigenCounts, EventCounts
from historian_tpu_torch.ops import felsenstein
from historian_tpu_torch.parallel import dist
from historian_tpu_torch.parallel.mesh import Mesh, dp_ep_mesh, global_devices

# Set by the CLI's -mesh flag (or HISTORIAN_MESH); read by the count path
# (engine/sumprod.accumulate_alignment_eigen_counts), the merge router
# (parallel/spmerge.py) and count_all (recon.py).
_ACTIVE_MESH: Mesh | None = None


def set_mesh(spec) -> Mesh:
    """Build and activate the count/fit mesh over the first global devices.

    spec is an int ("-mesh 8": dp only) or "DxE" ("-mesh 4x2": a (dp, ep)
    mesh, alignment columns over dp and mixture components over ep; the
    model's component count must be divisible by E)."""
    global _ACTIVE_MESH
    devices = global_devices()
    dp, ep = (int(spec), 1) if not (isinstance(spec, str) and "x" in spec) else (
        int(spec.split("x")[0]), int(spec.split("x")[1])
    )
    if dp * ep > len(devices):
        raise ValueError(
            f"-mesh {spec} requests {dp * ep} devices but only {len(devices)} are visible"
        )
    mesh = dp_ep_mesh(devices, dp, ep)
    # every process decides alike (one global list), so all of them raise
    # here rather than one waiting in a collective for another that cannot
    # compute on a mesh without its devices
    held = len({d.process for d in mesh.devices.flat})
    if held < dist.process_count():
        raise ValueError(f"-mesh {spec} holds devices of {held} of the {dist.process_count()} "
                         "processes; in a process group a mesh must hold devices of each")
    _ACTIVE_MESH = mesh
    return _ACTIVE_MESH


def _mesh_dp(mesh: Mesh) -> int:
    return mesh.shape["dp"] if "dp" in mesh.axis_names else mesh.size


def _mesh_ep(mesh: Mesh) -> int:
    return mesh.shape["ep"] if "ep" in mesh.axis_names else 1


def clear_mesh() -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = None


def active_mesh() -> Mesh | None:
    return _ACTIVE_MESH


def _first_local(mesh: Mesh) -> torch.device:
    """Where the process sums its shards: its first mesh device, or the
    selected device where the mesh holds none of its devices."""
    local = mesh.local_devices()
    return local[0] if local else devmod.current()


# ------------------------------------------------- sharded E-step counts
def _sharded_count_step(tokens, arrays, sub, ins, lcw, evec, evec_inv, jint, mesh: Mesh):
    """One E-step over an alignment on the mesh: each (dp block, ep block)
    shard fills its column block for its components (up and down passes)
    and contracts its eigencount partials on its device.  On a (dp, ep)
    mesh the one coupling across components, col_ll =
    logsumexp_c(lcw + cpt_ll), is rebuilt from the blocks' maxima and sums
    (the JAX pmax + psum).  A process computes the shards of its own
    devices (and a dp row's other component blocks' up passes, where it
    holds part of the row); the sum over processes is an all-reduce.
    tokens [N, L] with L divisible by dp; sub [N, C, A, A], ins [C, A],
    lcw [C], evec, evec_inv [C, A, A] and jint [N, C, A, A] numpy (real,
    or complex for a complex eigensystem).  Returns (root [C, A], eigen
    [C, A, A] complex128, log-likelihood), as numpy."""
    n_dp, n_ep = _mesh_dp(mesh), _mesh_ep(mesh)
    grid = mesh.devices.reshape(n_dp, n_ep)
    N, L = tokens.shape
    C, A = ins.shape
    block, ce = L // n_dp, C // n_ep
    acc = _first_local(mesh)
    root = torch.zeros((C, A), dtype=torch.float64, device=acc)
    eig = torch.zeros((C, A, A), dtype=torch.complex128, device=acc)
    lp = torch.zeros((), dtype=torch.float64, device=acc)
    real = not any(np.any(np.imag(a)) for a in (evec, evec_inv, jint))  # exactly real
    if real:
        evec, evec_inv, jint = (np.real(a) for a in (evec, evec_inv, jint))
    contract = felsenstein.eigen_counts if real else felsenstein.eigen_counts_cplx

    def t(a, dev):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    parent_safe = np.maximum(arrays.parent, 0)
    sib_safe = np.maximum(arrays.sibling, 0)
    for r in range(n_dp):
        row = grid[r]
        if not any(d.is_local for d in row):
            continue
        tok = tokens[:, r * block : (r + 1) * block]
        gap = tok.T == felsenstein.GAP_TOK  # [L_s, N]
        gap_parent = np.where(arrays.parent[None, :] >= 0, gap[:, parent_safe], True)
        mask = (~gap) & (arrays.parent >= 0)[None, :] & ~gap_parent
        is_root = (~gap) & gap_parent
        all_gap = gap.all(axis=1)
        shards = []
        for e in range(n_ep):
            dev = row[e].device if row[e].is_local else acc
            cs = slice(e * ce, (e + 1) * ce)
            sub_e, ins_e, lcw_e = t(sub[:, cs], dev), t(ins[cs], dev), t(lcw[cs], dev)
            up = felsenstein.fill_up(tok, arrays, sub_e, ins_e, lcw_e)
            shards.append((dev, cs, sub_e, ins_e, lcw_e, up))
        if n_ep > 1:
            # the global column likelihood over every component block
            scores = [(s[4][None, :] + s[5][4]).to(acc) for s in shards]  # [L_s, C_e]
            gmax = torch.stack([sc.max(dim=1).values for sc in scores]).max(dim=0).values
            sums = sum(torch.exp(sc - gmax[:, None]).sum(dim=1) for sc in scores)
            col_ll = torch.where(torch.as_tensor(all_gap, device=acc), 0.0, gmax + torch.log(sums))
        else:
            col_ll = shards[0][5][5].to(acc)
        for e, (dev, cs, sub_e, ins_e, lcw_e, up) in enumerate(shards):
            if not row[e].is_local:
                continue
            F, logF, E, logE, _, _ = up
            G, logG = felsenstein.fill_down(E, logE, t(gap, dev), arrays, sub_e, ins_e)
            cl = col_ll.to(dev)
            part = contract(F, logF, E, logE, G, logG, cl, t(parent_safe, dev), t(sib_safe, dev),
                            t(mask, dev), torch.ones(tok.shape[1], dtype=torch.float64, device=dev),
                            lcw_e, t(evec[cs], dev), t(evec_inv[cs], dev), t(jint[:, cs], dev))
            norm = torch.where(t(is_root, dev)[:, :, None],
                               torch.exp(lcw_e[None, None, :] + logF - cl[:, None, None]), 0.0)
            root[cs] += torch.einsum("lnc,ci,lnci->ci", norm, ins_e, F).to(acc)
            eig[cs] += part.to(acc)
            if e == 0:
                lp += cl.sum().to(acc)
    if mesh.spans_processes:
        flat = torch.cat([root.reshape(-1), torch.view_as_real(eig).reshape(-1), lp[None]])
        flat = _all_reduce_sum(flat)
        root = flat[: C * A].reshape(C, A)
        eig = torch.view_as_complex(flat[C * A : C * A + 2 * C * A * A].reshape(C, A, A, 2)
                                    .contiguous())
        lp = flat[-1]
    return root.cpu().numpy(), eig.cpu().numpy(), float(lp)


def sharded_alignment_eigen_counts(model, tree, gapped_rows: list, mesh: Mesh,
                                   weight: float = 1.0) -> EigenCounts:
    """Multi-device counterpart of engine.sumprod.accumulate_alignment_eigen_counts:
    one sharded E-step over the alignment's columns.  The result does not
    depend on the shard count beyond float reassociation, because the
    count algebra is associative.  All-gap padding columns (up to a
    multiple of dp) contribute nothing."""
    from historian_tpu_torch.engine.sumprod import SumProductEngine

    engine = SumProductEngine(model, tree)
    tokens = felsenstein.tokenize_alignment(model.alphabet, gapped_rows)  # [N, L]
    n_ep = _mesh_ep(mesh)
    if model.components % n_ep:
        raise ValueError(
            f"-mesh ep={n_ep} requires the model's component count "
            f"({model.components}) to be divisible by it"
        )
    n_dp = _mesh_dp(mesh)
    pad = (-tokens.shape[1]) % n_dp
    if pad:
        tokens = np.concatenate(
            [tokens, np.full((tokens.shape[0], pad), felsenstein.GAP_TOK, tokens.dtype)], axis=1
        )
    e = engine.eigen
    root, eig, lp = _sharded_count_step(
        tokens, engine.arrays, engine.branch_sub, engine.ins_prob, engine.log_cpt_weight,
        e.evec, e.evec_inv, engine.branch_eigen_sub_count, mesh,
    )
    out = EigenCounts(model.components, model.alphabet_size)
    out.root_count += root * weight
    out.eigen_count += eig * weight
    out.indel.lp = lp * weight
    return out


# ------------------------------------------------ EventCounts as tensors
def counts_to_arrays(c: EventCounts) -> dict:
    """EventCounts as float64 tensors (summable)."""
    ic = c.indel
    return {
        "root": torch.as_tensor(c.root_count, dtype=torch.float64),
        "sub": torch.as_tensor(c.sub_count, dtype=torch.float64),
        "indel": torch.tensor(
            [ic.ins, ic.del_, ic.ins_ext, ic.del_ext, ic.ins_time, ic.del_time, ic.lp],
            dtype=torch.float64,
        ),
    }


def arrays_to_counts(tree: dict, alphabet) -> EventCounts:
    root = tree["root"].cpu().numpy()
    out = EventCounts(alphabet, root.shape[0])
    out.root_count = root.copy()
    out.sub_count = tree["sub"].cpu().numpy().copy()
    ic = out.indel
    ic.ins, ic.del_, ic.ins_ext, ic.del_ext, ic.ins_time, ic.del_time, ic.lp = (
        float(v) for v in tree["indel"].tolist()
    )
    return out


def psum_counts(shard_counts: list, alphabet, mesh: Mesh | None = None) -> EventCounts:
    """Reduce per-shard EventCounts of this process.

    With a mesh: the shards fold onto the dp axis (padded with zero counts
    when fewer than its devices), each shard's tensors go to its dp
    device, and they are summed on the first (the JAX psum).  Without:
    the host algebra (the `sum` command's reducer)."""
    if mesh is None:
        total = shard_counts[0].copy()
        for c in shard_counts[1:]:
            total += c
        return total
    n_dp = _mesh_dp(mesh)
    if len(shard_counts) > n_dp:
        # fold the tail onto the first shards so one sum suffices
        folded = [c.copy() for c in shard_counts[:n_dp]]
        for i, c in enumerate(shard_counts[n_dp:]):
            folded[i % n_dp] += c
        shard_counts = folded
    components = shard_counts[0].components
    while len(shard_counts) < n_dp:
        shard_counts = shard_counts + [EventCounts(alphabet, components)]
    row0 = mesh.devices.reshape(n_dp, -1)[:, 0]
    acc = _first_local(mesh)
    total = None
    for c, d in zip(shard_counts, row0):
        on = {k: v.to(d.device if d.is_local else acc) for k, v in counts_to_arrays(c).items()}
        total = on if total is None else {k: total[k] + on[k].to(acc) for k in total}
    return arrays_to_counts(total, alphabet)


def _all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over the process group (on the group's device), back on
    t's device."""
    import torch.distributed as tdist

    buf = t.to(dist.comm_device()).contiguous()
    tdist.all_reduce(buf)
    return buf.to(t.device)


def allgather_bytes(data: bytes) -> list:
    """One byte payload a process, gathered across the process group:
    every process returns the same list, by rank (lengths first, then the
    payloads padded to the longest)."""
    import torch.distributed as tdist

    dev = dist.comm_device()
    n = dist.process_count()
    lens = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(n)]
    tdist.all_gather(lens, torch.tensor([len(data)], dtype=torch.int64, device=dev))
    lens = [int(x.item()) for x in lens]
    m = max(max(lens), 1)
    buf = torch.zeros(m, dtype=torch.uint8)
    buf[: len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    out = [torch.zeros(m, dtype=torch.uint8, device=dev) for _ in range(n)]
    tdist.all_gather(out, buf.to(dev))
    return [bytes(o[:k].cpu().numpy().tobytes()) for o, k in zip(out, lens)]


def allreduce_counts(partial: EventCounts, alphabet) -> EventCounts:
    """Sum per-process partial EventCounts (each process counted its
    round-robin share of the datasets) over the process group; every
    process returns the same totals."""
    arrs = counts_to_arrays(partial)
    sizes = [v.numel() for v in arrs.values()]
    flat = _all_reduce_sum(torch.cat([v.reshape(-1) for v in arrs.values()]))
    parts = torch.split(flat.cpu(), sizes)
    summed = {k: p.reshape(v.shape) for (k, v), p in zip(arrs.items(), parts)}
    return arrays_to_counts(summed, alphabet)


def column_sharded_eigen_counts(model, tree, gapped_rows: list, n_shards: int) -> EigenCounts:
    """Host-loop oracle of the column-sharded E-step: the tests hold the
    mesh path to it (its result must not depend on n_shards)."""
    from historian_tpu_torch.engine.sumprod import SumProductEngine

    engine = SumProductEngine(model, tree)
    n_cols = len(gapped_rows[0])
    block = math.ceil(n_cols / n_shards)
    total = EigenCounts(model.components, model.alphabet_size)
    for s in range(n_shards):
        cols = [row[s * block : (s + 1) * block] for row in gapped_rows]
        pad = block - len(cols[0])
        if pad:
            cols = [c + "-" * pad for c in cols]
        if not cols[0]:
            continue
        fill = engine.fill(cols)
        shard = EigenCounts(model.components, model.alphabet_size)
        fill.accumulate_eigen_counts(shard.root_count, shard.eigen_count)
        shard.indel.lp = float(fill.col_ll.sum())
        total += shard
    return total
