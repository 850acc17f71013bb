"""Deterministic network fault injection for the subprocess fleet.

Counterpart of ``photon_tpu/serving/netfault.py``, host-only: the same
rules, the same seeded draws and therefore the same fault sequence for the
same plan and traffic.  The serving transport (``serving/transport.py``) moves length-prefixed
frames over loopback TCP: one ``sock.sendall`` per outbound frame, one
``_read_exact`` pair per inbound frame.  That framing makes the wire a
clean injection seam — this module wraps a connected socket in a shim
that sees WHOLE frames and applies a seeded :class:`NetFaultPlan` to
them, so every partition/duplicate/reorder/slow-link scenario the fleet
must survive is a reproducible test cell, never a flake.

Primitives (per :class:`LinkRule`, matched to links by fnmatch pattern,
per direction):

- ``drop_p`` / ``dup_p`` / ``reorder_p`` — seeded per-frame drop,
  duplicate, and adjacent-swap reordering.
- ``delay_s`` — fixed per-frame latency (slow-replica mode).
- ``rate_bytes_per_s`` — per-direction byte-rate throttle.
- ``partitions`` — scheduled ``(start_s, end_s)`` windows (relative to
  :meth:`NetFaultPlan.activate`) during which frames are black-holed;
  ``end_s=None`` is a permanent partition (frozen-replica mode).  A
  rule with ``direction="send"`` or ``"recv"`` makes it one-way.
- ``skew_s`` — rewrites the child's self-reported clock fields
  (``child_time`` and span timestamps) in inbound frames, simulating a
  replica whose wall clock disagrees with the parent's.

Faults are injected at the PARENT's socket (``_RemoteScorer._connect``
wraps via :func:`maybe_shim`), so "send" means parent->child and "recv"
means child->parent.  Drops black-hole frames without disturbing the
TCP connection itself — exactly how a mid-path partition looks to the
endpoints — which is what forces the lease/seq/generation machinery to
do the real work: a dropped frame is silence, not an error.

Determinism: every random decision draws from a per-(link, direction)
``random.Random`` seeded from ``plan.seed``, and partition windows are
anchored to the plan's activation instant — replaying the same plan
against the same traffic yields the same fault sequence.  (This module
deliberately does NOT use ``fault/injection.py``'s consume-one
``FaultPlan``: frame faults are probabilistic streams over an open-ended
frame sequence, not one-shot site triggers, and the two grammars would
fight over a name — hence ``NetFaultPlan``.)
"""

from __future__ import annotations

import fnmatch
import random
import socket
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = [
    "LinkRule",
    "NetFaultPlan",
    "FrameShimSocket",
    "set_net_plan",
    "active_net_plan",
    "maybe_shim",
    "partition",
]


@dataclass(frozen=True)
class LinkRule:
    """One fault recipe, applied to every frame on the links it matches.

    ``link`` is an fnmatch pattern over the shim's link names — the
    parent names its sockets ``"<replica_id>:data"`` and
    ``"<replica_id>:ctrl"``, so ``"r0:*"`` faults one replica's both
    channels and ``"*"`` faults the whole fleet.
    """

    link: str = "*"
    direction: str = "both"  # "send" (parent->child), "recv", or "both"
    drop_p: float = 0.0
    dup_p: float = 0.0
    reorder_p: float = 0.0
    delay_s: float = 0.0
    rate_bytes_per_s: float = 0.0
    #: ((start_s, end_s_or_None), ...) black-hole windows relative to
    #: plan activation; end None = never heals (frozen replica).
    partitions: Tuple[Tuple[float, Optional[float]], ...] = ()
    skew_s: float = 0.0

    def matches(self, link: str, direction: str) -> bool:
        return (
            self.direction in ("both", direction)
            and fnmatch.fnmatch(link, self.link)
        )


def partition(
    link: str,
    start_s: float,
    duration_s: Optional[float] = None,
    direction: str = "both",
) -> LinkRule:
    """Convenience: a pure partition rule healing after ``duration_s``
    (``None`` = never — the frozen-replica cell)."""
    end = None if duration_s is None else float(start_s) + float(duration_s)
    return LinkRule(
        link=link,
        direction=direction,
        partitions=((float(start_s), end),),
    )


class NetFaultPlan:
    """A seeded set of :class:`LinkRule`\\ s plus the bookkeeping that
    makes a chaos cell assertable: per-event counters keyed
    ``"{event}:{link}:{direction}"`` count every injected fault."""

    def __init__(self, rules: List[LinkRule], seed: int = 0):
        self.rules = tuple(rules)
        self.seed = int(seed)
        self.counters: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._rngs: Dict[Tuple[str, str], random.Random] = {}
        self._epoch: Optional[float] = None

    # -- lifecycle -----------------------------------------------------------
    def activate(self) -> "NetFaultPlan":
        """Anchor partition windows to NOW (idempotent)."""
        if self._epoch is None:
            self._epoch = time.monotonic()
        return self

    def elapsed_s(self) -> float:
        if self._epoch is None:
            self.activate()
        return time.monotonic() - self._epoch

    # -- matching / determinism ----------------------------------------------
    def applies(self, link: str) -> bool:
        return any(
            fnmatch.fnmatch(link, r.link) for r in self.rules
        )

    def rules_for(self, link: str, direction: str) -> List[LinkRule]:
        return [r for r in self.rules if r.matches(link, direction)]

    def rng(self, link: str, direction: str) -> random.Random:
        with self._lock:
            key = (link, direction)
            r = self._rngs.get(key)
            if r is None:
                r = random.Random(
                    self.seed ^ zlib.crc32(f"{link}:{direction}".encode())
                )
                self._rngs[key] = r
            return r

    def partition_active(self, rule: LinkRule) -> bool:
        if not rule.partitions:
            return False
        t = self.elapsed_s()
        for start, end in rule.partitions:
            if t >= start and (end is None or t < end):
                return True
        return False

    # -- counters ------------------------------------------------------------
    def count(self, event: str, link: str, direction: str) -> None:
        with self._lock:
            key = f"{event}:{link}:{direction}"
            self.counters[key] = self.counters.get(key, 0) + 1

    def total(self, event: str) -> int:
        with self._lock:
            prefix = event + ":"
            return sum(
                v for k, v in self.counters.items() if k.startswith(prefix)
            )


# Module-level installed plan: the parent process installs a plan before
# connecting (or reconnecting) to its children; _RemoteScorer._connect
# routes every new socket through maybe_shim so reconnects inside a chaos
# cell stay faulted too.
_PLAN: Optional[NetFaultPlan] = None
_PLAN_LOCK = threading.Lock()


def set_net_plan(plan: Optional[NetFaultPlan]) -> None:
    """Install (and activate) ``plan`` for every subsequently wrapped
    socket; ``None`` clears it.  Already-wrapped sockets keep their plan
    — clear BEFORE building a fleet for a clean run."""
    global _PLAN
    with _PLAN_LOCK:
        if plan is not None:
            plan.activate()
        _PLAN = plan


def active_net_plan() -> Optional[NetFaultPlan]:
    return _PLAN


def maybe_shim(sock: socket.socket, link: str):
    """Wrap ``sock`` in a :class:`FrameShimSocket` when the installed
    plan has a rule matching ``link``; otherwise return it untouched
    (zero overhead on the clean path)."""
    plan = _PLAN
    if plan is None or not plan.applies(link):
        return sock
    return FrameShimSocket(sock, link, plan)


def _rewrite_skew(frame: bytes, skew_s: float) -> bytes:
    """Shift the child's self-reported clock fields in one wire frame by
    ``skew_s``: ``child_time`` on pong frames, span ``start`` and event
    ``t`` stamps on score/spans frames.  Unparseable frames pass through
    untouched."""
    from photon_tpu_torch.serving.transport import _pack, _unpack

    try:
        header, arrays = _unpack(frame[4:])
    except Exception:
        return frame
    touched = False
    if "child_time" in header:
        header["child_time"] = float(header["child_time"]) + skew_s
        touched = True
    for span in header.get("spans") or ():
        if "start" in span:
            span["start"] = float(span["start"]) + skew_s
            touched = True
        for ev in span.get("events") or ():
            if "t" in ev:
                ev["t"] = float(ev["t"]) + skew_s
                touched = True
    if not touched:
        return frame
    header["_arrays"] = [
        (m["slot"], m["name"], arr)
        for m, arr in zip(header.pop("arrays", []), arrays)
    ]
    payload = _pack(header)
    return struct.pack("!I", len(payload)) + payload


class FrameShimSocket:
    """Socket wrapper that reassembles the transport's length-prefixed
    frames and applies the plan's matching rules per frame.

    Send side: one ``sendall`` is one frame (the transport guarantees
    it), so drop/partition silently swallow the call — the sender sees
    success, exactly like a mid-path loss.  Recv side: wire bytes are
    buffered until a whole frame is available, faults are applied to the
    frame, and surviving bytes are replayed to the transport's
    ``recv(n)`` loop.  ``socket.timeout`` mid-frame is safe — partial
    wire bytes persist across calls.  EOF propagates as ``b""``.
    """

    def __init__(self, sock: socket.socket, link: str, plan: NetFaultPlan):
        self._sock = sock
        self.link = link
        self.plan = plan
        self._wire = bytearray()   # raw bytes off the wire, pre-framing
        self._rbuf = bytearray()   # post-fault frame bytes owed to recv()
        self._held_send: Optional[bytes] = None

    # -- passthrough ---------------------------------------------------------
    def __getattr__(self, name):
        return getattr(self._sock, name)

    def settimeout(self, t):
        self._sock.settimeout(t)

    def gettimeout(self):
        return self._sock.gettimeout()

    def close(self):
        self._held_send = None
        self._sock.close()

    # -- send path -----------------------------------------------------------
    def sendall(self, data) -> None:
        rules = self.plan.rules_for(self.link, "send")
        if not rules:
            self._sock.sendall(data)
            return
        for rule in rules:
            if self.plan.partition_active(rule):
                self.plan.count("partitioned", self.link, "send")
                return  # black-holed: sender sees success
            if rule.drop_p and self.plan.rng(
                self.link, "send"
            ).random() < rule.drop_p:
                self.plan.count("dropped", self.link, "send")
                return
        self._sleep_for(rules, len(data), "send")
        held, self._held_send = self._held_send, None
        if held is None and any(
            r.reorder_p
            and self.plan.rng(self.link, "send").random() < r.reorder_p
            for r in rules
        ):
            # Hold this frame; it ships AFTER the next one (adjacent swap).
            self._held_send = bytes(data)
            self.plan.count("reordered", self.link, "send")
            return
        self._sock.sendall(data)
        if held is not None:
            self._sock.sendall(held)
        for rule in rules:
            if rule.dup_p and self.plan.rng(
                self.link, "send"
            ).random() < rule.dup_p:
                self.plan.count("duplicated", self.link, "send")
                self._sock.sendall(data)
                break

    def _sleep_for(self, rules, nbytes: int, direction: str) -> None:
        delay = 0.0
        for rule in rules:
            delay += rule.delay_s
            if rule.rate_bytes_per_s:
                delay += nbytes / rule.rate_bytes_per_s
                self.plan.count("throttled", self.link, direction)
        if delay > 0:
            time.sleep(delay)

    # -- recv path -----------------------------------------------------------
    def recv(self, n: int) -> bytes:
        while not self._rbuf:
            frame = self._next_wire_frame()
            if frame is None:
                return b""
            for out in self._inbound(frame):
                self._rbuf += out
        k = min(int(n), len(self._rbuf))
        out = bytes(self._rbuf[:k])
        del self._rbuf[:k]
        return out

    def _next_wire_frame(self) -> Optional[bytes]:
        """One whole wire frame (length prefix included), or None on EOF.
        Raises socket.timeout with partial bytes preserved."""
        while True:
            if len(self._wire) >= 4:
                (n,) = struct.unpack("!I", bytes(self._wire[:4]))
                if len(self._wire) >= 4 + n:
                    frame = bytes(self._wire[: 4 + n])
                    del self._wire[: 4 + n]
                    return frame
            chunk = self._sock.recv(1 << 16)
            if not chunk:
                return None
            self._wire += chunk

    def _inbound(self, frame: bytes) -> List[bytes]:
        rules = self.plan.rules_for(self.link, "recv")
        if not rules:
            return [frame]
        for rule in rules:
            if self.plan.partition_active(rule):
                self.plan.count("partitioned", self.link, "recv")
                return []
            if rule.drop_p and self.plan.rng(
                self.link, "recv"
            ).random() < rule.drop_p:
                self.plan.count("dropped", self.link, "recv")
                return []
        self._sleep_for(rules, len(frame), "recv")
        skew = sum(r.skew_s for r in rules)
        if skew:
            frame = _rewrite_skew(frame, skew)
            self.plan.count("skewed", self.link, "recv")
        out = [frame]
        for rule in rules:
            if rule.dup_p and self.plan.rng(
                self.link, "recv"
            ).random() < rule.dup_p:
                self.plan.count("duplicated", self.link, "recv")
                out.append(frame)
                break
        if any(
            r.reorder_p
            and self.plan.rng(self.link, "recv").random() < r.reorder_p
            for r in rules
        ):
            # Adjacent swap: deliver the NEXT wire frame first (raw — the
            # swap itself is the fault under test), then this one.
            nxt = None
            old = self._sock.gettimeout()
            try:
                self._sock.settimeout(min(old, 0.2) if old else 0.2)
                nxt = self._next_wire_frame()
            except socket.timeout:
                nxt = None
            finally:
                try:
                    self._sock.settimeout(old)
                except OSError:
                    pass
            if nxt is not None:
                self.plan.count("reordered", self.link, "recv")
                out = [nxt] + out
        return out
