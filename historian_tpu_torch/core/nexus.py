"""Nexus format (DATA + TREES blocks) read/write.

Counterpart of the reference's crude Nexus parser
(reference src/nexus.h:11-28): strips #- and []-comments, reads the
MATRIX rows and a single TREE, converts between Nexus gap/wildcard chars
('-', '?') and internal ones ('-', '*').
"""

from __future__ import annotations

from dataclasses import dataclass, field

from historian_tpu_torch.core.seqs import FastSeq
from historian_tpu_torch.core.tree import Tree

NEXUS_GAP = "-"
NEXUS_WILDCARD = "?"
DEFAULT_TREE_NAME = "tree"


@dataclass
class NexusData:
    gapped: list[FastSeq] = field(default_factory=list)
    tree: Tree | None = None
    tree_name: str = DEFAULT_TREE_NAME

    @classmethod
    def parse(cls, text: str) -> "NexusData":
        # strip comments
        out_chars: list[str] = []
        state = 0  # 0 none, 1 hash, 2 bracket
        for c in text:
            if state == 0:
                if c == "#":
                    state = 1
                elif c == "[":
                    state = 2
                else:
                    out_chars.append(c)
            elif state == 1:
                if c == "\n":
                    state = 0
            else:
                if c == "]":
                    state = 0
        preproc = "".join(out_chars)

        data = cls()
        seq: dict[str, str] = {}
        row_names: list[str] = []
        block = None
        for stmt in preproc.split(";"):
            tok = stmt.split()
            if not tok:
                continue
            cmd = tok[0].upper()
            if block is None:
                if len(tok) == 2 and cmd == "BEGIN":
                    kind = tok[1].upper()
                    if kind == "DATA":
                        block = "data"
                    elif kind in ("TREE", "TREES"):
                        block = "tree"
            elif block == "data":
                if len(tok) == 1 and cmd == "END":
                    block = None
                elif cmd == "MATRIX":
                    if len(tok) % 2 != 1:
                        raise ValueError("MATRIX block does not have an even number of fields")
                    for n in range(1, len(tok), 2):
                        if tok[n] not in seq:
                            row_names.append(tok[n])
                            seq[tok[n]] = ""
                        seq[tok[n]] += tok[n + 1]
            elif block == "tree":
                if len(tok) == 1 and cmd == "END":
                    block = None
                elif cmd == "TREE" and len(tok) == 4 and tok[2] == "=":
                    if data.tree is not None:
                        raise ValueError("multiple trees in Nexus file")
                    data.tree_name = tok[1]
                    data.tree = Tree(tok[3] + ";")
        if not row_names:
            raise ValueError("no sequence data found in Nexus file")
        if data.tree is None:
            raise ValueError("no tree found in Nexus file")
        data.gapped = [FastSeq(name=n, seq=seq[n]) for n in row_names]
        return data

    @classmethod
    def read(cls, path: str) -> "NexusData":
        with open(path) as f:
            return cls.parse(f.read())

    def convert_nexus_to_alignment(self) -> None:
        for fs in self.gapped:
            fs.seq = fs.seq.replace(NEXUS_WILDCARD, "*")

    def convert_alignment_to_nexus(self) -> None:
        for fs in self.gapped:
            fs.seq = fs.seq.replace("*", NEXUS_WILDCARD)

    def to_string(self) -> str:
        out = ["#NEXUS", "BEGIN DATA;"]
        if self.gapped:
            out.append(
                f"DIMENSIONS NTAX={len(self.gapped)} NCHAR={len(self.gapped[0].seq)};"
            )
            out.append("MATRIX")
            w = max(len(fs.name) for fs in self.gapped)
            for fs in self.gapped:
                out.append(f"{fs.name:<{w + 1}}{fs.seq}")
            out.append(";")
        out.append("END;")
        out.append("BEGIN TREES;")
        out.append(f"TREE {self.tree_name} = {self.tree.to_string()}")
        out.append("END;")
        return "\n".join(out) + "\n"
