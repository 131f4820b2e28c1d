"""Guide-alignment graph: pairwise align a set of edges, take the maximum
spanning tree, merge the MST paths into one multiple alignment.

Port of historian_tpu/engine/span.py::AlignGraph, unchanged but for the
aligner: the pairs go through the port's QuickAligner
(engine/quickalign.py), one guide-kernel call for the whole edge set.
Edge sets are either all-vs-all (-allspan) or an Erdos-Renyi-style random
graph of ~N*log2(N) edges grown until connected, drawn from MT19937; the
MST and union-find stay on the host (N is small).
"""

from __future__ import annotations

import heapq
import math

import numpy as np

from historian_tpu_torch.core.alignpath import AlignPath, Alignment, align_path_merge
from historian_tpu_torch.core.seqs import FastSeq
from historian_tpu_torch.engine.diagenv import DiagEnvParams, DiagonalEnvelope
from historian_tpu_torch.engine.quickalign import QuickAligner
from historian_tpu_torch.utils.logging import ProgressLogger
from historian_tpu_torch.utils.rng import MT19937


class _Partition:
    def __init__(self, n: int):
        self.idx = list(range(n))
        self.sets: list[set[int]] = [{i} for i in range(n)]
        self.n_sets = n

    def same(self, a: int, b: int) -> bool:
        return self.idx[a] == self.idx[b]

    def merge(self, a: int, b: int) -> None:
        if self.same(a, b):
            return
        i1, i2 = sorted((self.idx[a], self.idx[b]))
        for m in self.sets[i2]:
            self.idx[m] = i1
        self.sets[i1] |= self.sets[i2]
        self.sets[i2] = set()
        self.n_sets -= 1


class AlignGraph:
    def __init__(
        self,
        seqs: list[FastSeq],
        model,
        time: float,
        diag_env_params: DiagEnvParams | None = None,
        rng: MT19937 | None = None,
        dense: bool = False,
    ):
        self.seqs = seqs
        self.model = model
        self.time = time
        self.params = diag_env_params or DiagEnvParams()
        self.edge_path: dict[tuple[int, int], AlignPath] = {}
        self.edges: list[list[tuple[float, int, int]]] = [[] for _ in seqs]
        if dense or rng is None:
            trial = [
                (src, dest)
                for src in range(len(seqs) - 1)
                for dest in range(src + 1, len(seqs))
            ]
        else:
            trial = self._sparse_random_edges(rng)
        self._build(trial)

    def _sparse_random_edges(self, rng: MT19937) -> list[tuple[int, int]]:
        n = len(self.seqs)
        n_edges = min(n * (n - 1) // 2, int(math.ceil(math.log(n) * n / math.log(2))))
        part = _Partition(n)
        targets: dict[int, set[int]] = {}
        trial: list[tuple[int, int]] = []
        count = 0
        while count < n_edges or part.n_sets > 1:
            while True:
                src = rng.next_u32() % n
                dest = rng.next_u32() % n
                if dest < src:
                    src, dest = dest, src
                if src != dest and dest not in targets.get(src, set()):
                    break
            targets.setdefault(src, set()).add(dest)
            trial.append((src, dest))
            part.merge(src, dest)
            count += 1
        return trial

    def _build(self, trial_edges: list[tuple[int, int]]) -> None:
        aligner = QuickAligner(self.model, self.time)
        progress = ProgressLogger(f"Guide alignment ({len(self.seqs)} sequences, {len(trial_edges)} pairs)")
        jobs = []
        for src, dest in trial_edges:
            x, y = self.seqs[src], self.seqs[dest]
            env = DiagonalEnvelope(len(x.seq), len(y.seq))
            if self.params.sparse:
                env.init_sparse(
                    self.model.alphabet.tokenize(x.seq),
                    self.model.alphabet.tokenize(y.seq),
                    self.model.alphabet_size,
                    self.params,
                )
            else:
                env.init_full()
            jobs.append((x, y, env))
        # every fill runs in one guide-kernel call; the heartbeat ticks
        # as the results are decoded
        results = aligner.align_batch(
            jobs,
            progress=lambda k, total: progress.update(k / max(1, total), f"pair {k + 1}/{total}"),
        )
        for n, ((src, dest), result) in enumerate(zip(trial_edges, results)):
            self.edge_path[(src, dest)] = result.align_path(src, dest)
            # negative lp: python heapq is a min-heap, reference uses max-heap
            heapq.heappush(self.edges[src], (-result.end, src, dest))
            heapq.heappush(self.edges[dest], (-result.end, src, dest))

    def min_span_tree(self) -> list[AlignPath]:
        paths: list[AlignPath] = []
        part = _Partition(len(self.seqs))
        while part.n_sets > 1:
            best = None
            for src in part.sets[0]:
                h = self.edges[src]
                while h and part.same(h[0][1], h[0][2]):
                    heapq.heappop(h)
                if h and (best is None or h[0][0] < best[0]):
                    best = h[0]
            if best is None:
                raise RuntimeError("found no valid edge")
            _, r1, r2 = best
            paths.append(self.edge_path[(r1, r2)])
            part.merge(r1, r2)
        return paths

    def mst_path(self) -> AlignPath:
        return align_path_merge(self.min_span_tree())

    def mst_align(self) -> Alignment:
        return Alignment(self.seqs, self.mst_path())

    def mst_gapped(self) -> list[FastSeq]:
        return self.mst_align().gapped()
