"""Collective-byte accounting: from compiled HLO text, or from the calls a
PyTorch program made.

Port of ``repro.perfmodel.hlo``.  Two sources fill one
:class:`CollectiveStats`, under the standard ring-algorithm conventions
(per-device link traffic; n = the collective's group size):

    all-reduce       2 * B * (n-1)/n     (B = result bytes)
    all-gather       B * (n-1)/n
    reduce-scatter   B * (n-1)            (operand = n*B)
    all-to-all       B * (n-1)/n
    collective-permute  B

- :func:`collective_bytes` parses a (per-device SPMD) HLO module, as the
  reference does, for HLO text a user brings (the reference's dry run
  writes it with ``--save-hlo``); :func:`count_op` counts an op in it.
- :func:`recorded_stats` takes the calls that
  ``dist.collectives.recording()`` recorded while one rank's program ran
  (the port's dry run, ``launch/dryrun.py``), with the same conventions.
"""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Optional

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# `%name = bf16[2,16,128]{...} all-reduce(` possibly tuple-typed:
# `%name = (f32[16,128], f32[16,128]) all-reduce(`
_OP_RE = re.compile(
    r"=\s*(?P<type>\([^)]*\)|[a-z0-9]+\[[0-9,]*\](?:\{[^}]*\})?)\s+"
    r"(?P<op>all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\("
)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_GROUPS_BRACE_RE = re.compile(r"replica_groups=\{\{([0-9, ]*)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d.strip():
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return max(int(m.group(2)), 1)
    m = _GROUPS_BRACE_RE.search(line)
    if m:
        elems = [e for e in m.group(1).split(",") if e.strip()]
        return max(len(elems), 1)
    return default


@dataclass
class CollectiveStats:
    per_device_bytes: float = 0.0  # link traffic per device (ring model)
    payload_bytes: float = 0.0  # raw result bytes (no algorithm factor)
    op_counts: dict = field(default_factory=lambda: defaultdict(int))
    op_bytes: dict = field(default_factory=lambda: defaultdict(float))

    def summary(self) -> dict:
        return {
            "per_device_bytes": self.per_device_bytes,
            "payload_bytes": self.payload_bytes,
            "op_counts": dict(self.op_counts),
            "op_bytes": {k: float(v) for k, v in self.op_bytes.items()},
        }


_COMP_HDR_RE = re.compile(r"^(?:ENTRY\s+)?(%?[\w\.\-_]+)\s*\(.*\{$")
_WHILE_RE = re.compile(r"\bwhile\(")
_BODY_REF_RE = re.compile(r"body=([%\w\.\-_]+)")
_COND_REF_RE = re.compile(r"condition=([%\w\.\-_]+)")
_CALL_REF_RE = re.compile(r"\b(?:calls|to_apply)=([%\w\.\-_]+)")
_CONST_INT_RE = re.compile(r"constant\((\d+)\)")


def _split_computations(hlo_text: str) -> dict[str, list[str]]:
    """computation name -> its body lines (flat HLO text format)."""
    comps: dict[str, list[str]] = {}
    cur: Optional[str] = None
    entry_marked: Optional[str] = None
    for line in hlo_text.splitlines():
        if cur is None:
            m = _COMP_HDR_RE.match(line.strip())
            if m and line.rstrip().endswith("{"):
                cur = m.group(1)
                if line.lstrip().startswith("ENTRY"):
                    entry_marked = cur
                comps[cur] = []
        else:
            if line.strip() == "}":
                cur = None
            else:
                comps[cur].append(line)
    if entry_marked:
        comps["__entry__"] = comps[entry_marked]
    return comps


def _line_collective(line: str, default_group: int):
    """(op, traffic_bytes, payload_bytes) or None for one HLO line."""
    m = _OP_RE.search(line)
    if m is None:
        return None
    if "-done(" in line:  # async pair: count only -start
        return None
    op = m.group("op")
    type_str = m.group("type")
    is_start = f"{op}-start(" in line
    if is_start and type_str.startswith("("):
        # tuple (operand, result): take the largest member
        b = max(
            (_shape_bytes(s) for s in re.findall(r"[a-z0-9]+\[[0-9,]*\]", type_str)),
            default=0,
        )
    else:
        b = _shape_bytes(type_str)
    n = _group_size(line, default_group)
    if op == "all-reduce":
        traffic = 2.0 * b * (n - 1) / max(n, 1)
    elif op in ("all-gather", "all-to-all"):
        traffic = b * (n - 1) / max(n, 1)
    elif op == "reduce-scatter":
        # sync form types the (small) result: operand = n*b ; async largest = operand
        traffic = float(b) * (n - 1) if not is_start else b * (n - 1) / max(n, 1)
    else:  # collective-permute
        traffic = float(b)
    return op, traffic, float(b)


def _trip_count(cond_lines: list[str]) -> int:
    """Trip count of a scan-style while: the max integer constant compared."""
    best = 1
    for line in cond_lines:
        if "compare(" in line or "constant(" in line:
            for c in _CONST_INT_RE.findall(line):
                best = max(best, int(c))
    return best


def collective_bytes(hlo_text: str, default_group: int = 1) -> CollectiveStats:
    """Loop-aware collective accounting: collectives inside while-loop bodies
    are multiplied by the loop trip count (XLA text lists the body once)."""
    comps = _split_computations(hlo_text)
    stats = CollectiveStats()
    if not comps:
        return stats

    def walk(name: str, seen: frozenset) -> tuple[float, float, dict, dict]:
        if name not in comps or name in seen:
            return 0.0, 0.0, {}, {}
        seen = seen | {name}
        traffic = payload = 0.0
        counts: dict = defaultdict(int)
        obytes: dict = defaultdict(float)
        for line in comps[name]:
            lc = _line_collective(line, default_group)
            if lc is not None:
                op, t, b = lc
                traffic += t
                payload += b
                counts[op] += 1
                obytes[op] += t
            if _WHILE_RE.search(line):
                bm = _BODY_REF_RE.search(line)
                cm = _COND_REF_RE.search(line)
                if bm:
                    trips = _trip_count(comps.get(cm.group(1), [])) if cm else 1
                    bt, bp, bc, bb = walk(bm.group(1), seen)
                    traffic += trips * bt
                    payload += trips * bp
                    for k, v in bc.items():
                        counts[k] += trips * v
                    for k, v in bb.items():
                        obytes[k] += trips * v
            else:
                for ref in _CALL_REF_RE.findall(line):
                    bt, bp, bc, bb = walk(ref, seen)
                    traffic += bt
                    payload += bp
                    for k, v in bc.items():
                        counts[k] += v
                    for k, v in bb.items():
                        obytes[k] += v
        return traffic, payload, dict(counts), dict(obytes)

    entry = "__entry__" if "__entry__" in comps else next(iter(comps))
    traffic, payload, counts, obytes = walk(entry, frozenset())
    stats.per_device_bytes = traffic
    stats.payload_bytes = payload
    stats.op_counts = defaultdict(int, counts)
    stats.op_bytes = defaultdict(float, obytes)
    return stats


def count_op(hlo_text: str, opname: str) -> int:
    return len(re.findall(rf"\b{re.escape(opname)}\(", hlo_text))


# ---------------------------------------------------------------------------
# the port's source: the calls one rank made
# ---------------------------------------------------------------------------
# dist.collectives' op -> (the HLO op it counts as, B from the call's wire
# bytes W, traffic from B and n)
_RECORDED = {
    "all_reduce": ("all-reduce", lambda w, n: w, lambda b, n: 2.0 * b * (n - 1) / n),
    "all_gather": ("all-gather", lambda w, n: w * n, lambda b, n: b * (n - 1) / n),
    "reduce_scatter": ("reduce-scatter", lambda w, n: w / n, lambda b, n: b * (n - 1)),
    "shift": ("collective-permute", lambda w, n: w, lambda b, n: float(b)),
    "broadcast": ("broadcast", lambda w, n: w, lambda b, n: float(b)),
    "reduce": ("reduce", lambda w, n: w, lambda b, n: float(b)),
}


def recorded_stats(calls) -> CollectiveStats:
    """:class:`CollectiveStats` of the calls one rank made, each a
    ``dist.collectives.CollectiveCall`` (op, axis, n, payload bytes, wire
    bytes), under the ring conventions above with B the result's bytes as
    the NCCL path moves them (``all_reduce``, ``reduce`` and
    ``reduce_scatter`` sum 16-bit floats in fp32, so their B is the fp32
    bytes).  ``shift`` counts as a
    collective-permute.  ``broadcast`` and ``reduce``, which have no HLO
    twin in the list, count B each: a pipelined ring passes the whole
    tensor over every link once, from the root out or towards it.  A call
    over one rank moves nothing.  ``op_counts`` and ``op_bytes`` are keyed
    by the HLO name; ``payload_bytes`` sums B."""
    stats = CollectiveStats()
    for c in calls:
        name, result, traffic = _RECORDED[c.op]
        b = result(c.wire_bytes, c.n)
        t = traffic(b, c.n) if c.n > 1 else 0.0
        stats.per_device_bytes += t
        stats.payload_bytes += b
        stats.op_counts[name] += 1
        stats.op_bytes[name] += t
    return stats
