"""Request-lifecycle and engine-step tracing, Chrome trace-event export.

The port's copy of ``repro.obs.trace`` (the port imports nothing of
``repro``): the same events in the same order, so a sim-mode export
of the port's engine equals the reference's event for event.

A ``TraceRecorder`` collects two kinds of timeline rows, loadable in
Perfetto (https://ui.perfetto.dev — "Open trace file") or
``chrome://tracing``:

  * **request spans** (pid 1, one thread per request id): a ``B``/``E``
    span opened at submit and closed exactly once when the request
    finishes, with instant events for every lifecycle transition —
    ``queued -> admitted -> prefill_chunk* -> first_token ->
    finished``, plus ``preempted`` / ``evicted_resume`` when the
    scheduler evicts and re-admits;
  * **engine steps** (pid 0): one ``X`` (complete) event per
    ``engine.step()`` carrying admissions, chunk tokens drained, decode
    batch size, tokens written, dispatch wall time, and a retrace flag,
    plus a ``C`` counter track of queue/pool occupancy.

Timestamp modes: events are stamped with whatever clock the caller
passes (``ts`` in seconds — the engines forward their ``now``
argument), so under the discrete-event ``serving/sim.py:Clock`` a trace
is fully deterministic.  ``mode="sim"`` additionally zeroes the
measured wall durations so the exported JSON is byte-stable under test;
``mode="wall"`` (the serve CLI / benchmarks) keeps them.

Recording appends one small tuple per event — cheap enough for the
engine step loop; dict building happens only at export.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

PID_ENGINE = 0
PID_REQUESTS = 1


class TraceRecorder:
    __slots__ = ("mode", "_events", "open_spans", "closed_spans")

    def __init__(self, mode: str = "wall"):
        if mode not in ("wall", "sim"):
            raise ValueError(f"mode must be 'wall' or 'sim', got {mode!r}")
        self.mode = mode
        # (ph, name, ts_s, pid, tid, dur_s, args)
        self._events: List[Tuple] = []
        self.open_spans: Dict[int, int] = {}     # rid -> open count
        self.closed_spans = 0

    @property
    def num_events(self) -> int:
        return len(self._events)

    # ------------------------------------------------------------ record
    def open_span(self, rid: int, ts: float, **args) -> None:
        self.open_spans[rid] = self.open_spans.get(rid, 0) + 1
        self._events.append(("B", "request", ts, PID_REQUESTS, rid, 0.0,
                             args))

    def close_span(self, rid: int, ts: float, outcome: str,
                   **args) -> None:
        args["outcome"] = outcome
        self.open_spans[rid] = self.open_spans.get(rid, 0) - 1
        self.closed_spans += 1
        self._events.append(("E", "request", ts, PID_REQUESTS, rid, 0.0,
                             args))

    def request(self, rid: int, phase: str, ts: float, **args) -> None:
        """Instant lifecycle event on the request's own track."""
        self._events.append(("i", phase, ts, PID_REQUESTS, rid, 0.0, args))

    def step(self, ts: float, wall_s: float, **args) -> None:
        """One engine step: ``X`` complete event on the engine track.
        ``ts`` is the step's (caller-clock) start; ``wall_s`` the
        measured dispatch wall time (zeroed in sim mode so exports stay
        deterministic — it still rides along in args as ``wall_ms``)."""
        if self.mode == "wall":
            args["wall_ms"] = round(wall_s * 1e3, 3)
        dur = wall_s if self.mode == "wall" else 0.0
        self._events.append(("X", "step", ts, PID_ENGINE, 0, dur, args))

    def counter(self, ts: float, name: str, **values) -> None:
        """Perfetto counter track (queue depth, pool occupancy...)."""
        self._events.append(("C", name, ts, PID_ENGINE, 0, 0.0, values))

    # ------------------------------------------------------------ export
    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (object form, ``traceEvents`` key)."""
        events = [
            {"name": "process_name", "ph": "M", "pid": PID_ENGINE, "tid": 0,
             "args": {"name": "engine"}},
            {"name": "process_name", "ph": "M", "pid": PID_REQUESTS,
             "tid": 0, "args": {"name": "requests"}},
        ]
        for ph, name, ts, pid, tid, dur, args in self._events:
            ev = {"name": name, "ph": ph, "ts": round(ts * 1e6, 3),
                  "pid": pid, "tid": tid}
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 3)
            if ph == "i":
                ev["s"] = "t"                     # thread-scoped instant
            if args:
                ev["args"] = args
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"clock_mode": self.mode}}

    def export(self, path: str) -> int:
        """Write the Chrome trace JSON; returns the event count."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return len(self._events)


def span_report(trace: dict) -> Dict[int, dict]:
    """Per-request span accounting from an exported Chrome trace dict:
    ``{rid: {"opens", "closes", "phases", "outcome"}}``.  The trace
    validity gate (and the completeness tests) assert on this: every
    finished request must close exactly once and carry at least one
    prefill event plus a ``first_token``."""
    out: Dict[int, dict] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("pid") != PID_REQUESTS or ev.get("ph") == "M":
            continue
        rid = ev["tid"]
        rec = out.setdefault(rid, {"opens": 0, "closes": 0, "phases": [],
                                   "outcome": None})
        if ev["ph"] == "B":
            rec["opens"] += 1
        elif ev["ph"] == "E":
            rec["closes"] += 1
            rec["outcome"] = (ev.get("args") or {}).get("outcome")
        else:
            rec["phases"].append(ev["name"])
    return out


def validate_chrome_trace(trace: dict,
                          finished_rids: Optional[list] = None) -> List[str]:
    """Structural validity check; returns a list of problems (empty ==
    valid).  Checks Chrome trace-event shape, per-event required
    fields, and — for every rid in ``finished_rids`` — a span that
    closed exactly once containing >= 1 prefill event and a
    ``first_token`` event."""
    problems = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["missing traceEvents list"]
    for i, ev in enumerate(events):
        for k in ("name", "ph", "pid", "tid"):
            if k not in ev:
                problems.append(f"event {i} missing {k!r}")
        if ev.get("ph") not in ("B", "E", "i", "X", "C", "M"):
            problems.append(f"event {i} bad ph {ev.get('ph')!r}")
        if ev.get("ph") != "M" and "ts" not in ev:
            problems.append(f"event {i} missing ts")
    rep = span_report(trace)
    for rid in finished_rids or []:
        rec = rep.get(rid)
        if rec is None:
            problems.append(f"request {rid}: no span events")
            continue
        if rec["opens"] != 1 or rec["closes"] != 1:
            problems.append(f"request {rid}: opens={rec['opens']} "
                            f"closes={rec['closes']} (want 1/1)")
        if not any(p.startswith("prefill") for p in rec["phases"]):
            problems.append(f"request {rid}: no prefill event")
        if "first_token" not in rec["phases"]:
            problems.append(f"request {rid}: no first_token event")
    return problems
