"""Automated gang post-mortem: merge every per-rank breadcrumb a failed
run leaves behind into one timeline and classify what ended it.

The port of lightgbm_tpu's ``postmortem.py``. A dead gang leaves its
evidence in five places: the per-rank, incarnation-suffixed
``flight_rank*.jsonl`` rings (``telemetry.py``), the ``watchdog_rank*.json``
stall diagnoses and ``divergence_rank*.json`` integrity verdicts
(``distributed.py``), the supervisor's ``GangFailure`` history (exit codes
a rank), and the checkpoint manifests' health sections. This module
correlates them:

- :func:`analyze` gathers every artifact it finds (directories, an
  optional ``GangFailure`` list, checkpoint manifests), merges them into
  a wall-clock-ordered timeline, and classifies the failure into one of
  the :data:`VERDICTS`, naming the first bad rank, the iteration and (for
  OOM) the memory trend before it from the flight records' samples.

- :class:`Postmortem` renders both ways: ``render()`` the report for a
  person, ``to_json()`` the machine document (``scripts/postmortem.py``
  writes both; ``supervisor.run_supervised`` runs the analysis when a gang
  fails and carries the report's path in ``SupervisorReport.postmortem`` /
  ``GangFailedError.postmortem``).

Classification ranks the evidence: a hung gang produces watchdog exits on
its healthy ranks (the exit is the symptom, the suspect list the
evidence), a killed rank exits 137 after a ``fault-kill`` flush, a
diverged rank writes its verdict before exiting 95, NaN runs leave a
``train-error`` flush naming the iteration, OOM runs the ladder's rungs
and an ``oom-exhausted`` flush. Priority: divergence > kill > OOM > NaN >
hang > unknown. It reads files only: the analysis of a copied artifact
directory needs no card.
"""

from __future__ import annotations

import glob
import json
import os
import re
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# verdicts in evidence-priority order (strongest first); "unknown" when
# nothing classifiable was found
VERDICTS = ("divergence", "kill", "oom", "nan", "hang", "unknown")

# exit codes (distributed.py's, declared again so the analysis of a
# copied artifact directory imports no training code)
KILL_EXIT_CODE = 137
DIVERGENCE_EXIT_CODE = 95
SPAWN_FAIL_EXIT_CODE = 96
WATCHDOG_EXIT_CODE = 97

_FLIGHT_RE = re.compile(r"flight_rank(\d+)(?:\.r(\d+))?\.jsonl$")

REPORT_JSON = "postmortem.json"
REPORT_TEXT = "postmortem.txt"


# ============================================================ gathering

@dataclass
class RankFlight:
    """One rank's parsed flight-recorder JSONL."""
    rank: int
    incarnation: int
    path: str
    context: Dict[str, Any] = field(default_factory=dict)
    iters: List[dict] = field(default_factory=list)
    flushes: List[dict] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)

    @property
    def last_iteration(self) -> int:
        done = [r["iteration"] + r.get("iters", 1) - 1
                for r in self.iters if r.get("completed")]
        return max(done) if done else -1


def _parse_flight(path: str, rank: int, incarnation: int) -> RankFlight:
    from . import telemetry
    fl = RankFlight(rank=rank, incarnation=incarnation, path=path)
    try:
        records, errors = telemetry.validate_flight_jsonl(path)
    except OSError as e:
        fl.errors.append(str(e))
        return fl
    fl.errors.extend(errors)
    for rec in records:
        t = rec.get("type")
        if t == "run":
            fl.context = rec.get("context") or {}
        elif t == "iter":
            fl.iters.append(rec)
        elif t == "flush":
            fl.flushes.append(rec)
    return fl


def gather_flights(dirs: List[str]) -> List[RankFlight]:
    """Find and parse every ``flight_rank*.jsonl`` (including the
    ``.rN`` incarnation-suffixed ones a supervised relaunch writes)
    under the given directories, newest incarnation last per rank."""
    out: List[RankFlight] = []
    seen = set()
    for d in dirs:
        for path in sorted(glob.glob(os.path.join(d, "flight_rank*.jsonl"))):
            if path in seen:
                continue
            seen.add(path)
            m = _FLIGHT_RE.search(os.path.basename(path))
            if not m:
                continue
            out.append(_parse_flight(path, int(m.group(1)),
                                     int(m.group(2) or 0)))
    out.sort(key=lambda f: (f.incarnation, f.rank))
    return out


def gather_diags(dirs: List[str]) -> List[dict]:
    """Watchdog / divergence diagnosis JSONs still on disk. (The
    supervisor CONSUMES these into ``GangFailure.watchdog`` as it reads
    them — pass the failure history to :func:`analyze` to cover the
    consumed ones.)"""
    out = []
    for d in dirs:
        for pat in ("watchdog_rank*.json", "divergence_rank*.json"):
            for path in sorted(glob.glob(os.path.join(d, pat))):
                try:
                    with open(path) as fh:
                        diag = json.load(fh)
                except (OSError, ValueError):
                    continue
                if "kind" not in diag:
                    # pre-PR watchdog diags carried no kind marker
                    diag["kind"] = ("divergence" if "divergence" in
                                    os.path.basename(path) else "watchdog")
                diag.setdefault("_path", path)
                out.append(diag)
    return out


def gather_manifests(checkpoint_dir: Optional[str]) -> List[dict]:
    """Health sections of every published checkpoint manifest (iteration
    + the health snapshot at write time) — the "last known good" marks
    on the timeline."""
    if not checkpoint_dir:
        return []
    out = []
    for path in sorted(glob.glob(os.path.join(checkpoint_dir, "ckpt_*",
                                              "MANIFEST.json"))):
        if path.split(os.sep)[-2].endswith(".tmp"):
            continue
        try:
            with open(path) as fh:
                man = json.load(fh)
        except (OSError, ValueError):
            continue
        out.append({"iteration": man.get("iteration"),
                    "health": man.get("health") or {}, "_path": path})
    return out


def _normalize_failures(failures) -> List[dict]:
    """Accept ``GangFailure`` objects or equivalent dicts; emit dicts
    with incarnation / failed_ranks / exit_codes / reason / watchdog."""
    out = []
    for f in failures or []:
        if isinstance(f, dict):
            d = dict(f)
        else:
            d = {"incarnation": getattr(f, "incarnation", 0),
                 "failed_ranks": list(getattr(f, "failed_ranks", [])),
                 "exit_codes": dict(getattr(f, "exit_codes", {}) or {}),
                 "reason": getattr(f, "reason", ""),
                 "watchdog": list(getattr(f, "watchdog", []) or []),
                 "world_size": getattr(f, "world_size", 0)}
        d["exit_codes"] = {int(r): c for r, c in
                           (d.get("exit_codes") or {}).items()
                           if c is not None}
        out.append(d)
    return out


# ============================================================= timeline

def _event(t, rank, kind, iteration, detail) -> dict:
    return {"t": t, "rank": rank, "kind": kind,
            "iteration": iteration, "detail": detail}


def build_timeline(flights: List[RankFlight], diags: List[dict],
                   failures: List[dict],
                   manifests: List[dict]) -> List[dict]:
    """Merge every artifact into one wall-clock-ordered event list.
    Per-iteration records are summarized (only state CHANGES make the
    timeline: OOM rung steps, incomplete steps, bad sentinel verdicts,
    plus each rank's last completed record) — the full rings stay in the
    JSONLs the report references. Events without a wall timestamp
    (exit codes) sort last."""
    events: List[dict] = []
    for fl in flights:
        prev_oom = 0
        for i, rec in enumerate(fl.iters):
            oom = int(rec.get("oom_level", 0))
            interesting = (oom != prev_oom
                           or not rec.get("completed", True)
                           or str(rec.get("sentinel", "")).startswith(
                               "flags=")
                           or i == len(fl.iters) - 1)
            prev_oom = oom
            if not interesting:
                continue
            bits = []
            if not rec.get("completed", True):
                bits.append("IN-FLIGHT (never completed)")
            if oom:
                bits.append(f"oom_level={oom}")
            sent = rec.get("sentinel")
            if str(sent).startswith("flags="):
                bits.append(f"sentinel {sent}")
            mem = rec.get("mem") or {}
            hbm = mem.get("hbm_bytes_in_use")
            rss = mem.get("host_rss_bytes")
            if hbm is not None:
                bits.append(f"hbm={hbm / 1e9:.2f}GB")
            if rss is not None:
                bits.append(f"rss={rss / 1e9:.2f}GB")
            events.append(_event(
                rec.get("t"), fl.rank, "iter", rec.get("iteration"),
                f"iteration {rec.get('iteration')} "
                + (" ".join(bits) if bits else "completed")))
        degr_seen = set()
        for flush in fl.flushes:
            events.append(_event(flush.get("t"), fl.rank, "flush", None,
                                 f"flush: {flush.get('reason')}"))
            for d in (flush.get("health") or {}).get("degradations") or []:
                key = (d.get("seq"), d.get("kind"), d.get("level"))
                if key in degr_seen:
                    continue
                degr_seen.add(key)
                extra = ""
                pb = d.get("predicted_hist_bytes")
                if pb:
                    extra += f" predicted_hist_bytes={pb}"
                hbm = (d.get("memory") or {}).get("hbm_bytes_in_use")
                if hbm is not None:
                    extra += f" hbm={hbm / 1e9:.2f}GB"
                events.append(_event(
                    d.get("t"), fl.rank, "degradation", d.get("iteration"),
                    f"degradation {d.get('kind')} level "
                    f"{d.get('level')}: {d.get('action')}{extra}"))
    for diag in diags:
        kind = diag.get("kind", "watchdog")
        if kind == "divergence":
            detail = (f"divergence verdict: rank {diag.get('rank')} voted "
                      f"corrupt (corrupt_ranks="
                      f"{diag.get('corrupt_ranks')})")
        else:
            detail = (f"watchdog fired on rank {diag.get('rank')}: phase "
                      f"{diag.get('phase')!r} stalled "
                      f"{diag.get('elapsed')}s (deadline "
                      f"{diag.get('deadline')}s), suspects "
                      f"{diag.get('suspects')}")
        events.append(_event(diag.get("t"), diag.get("rank"), kind,
                             diag.get("iteration"), detail))
    for man in manifests:
        h = man.get("health") or {}
        events.append(_event(None, None, "checkpoint", man.get("iteration"),
                             f"checkpoint published at iteration "
                             f"{man.get('iteration')} (restart_count "
                             f"{h.get('restart_count')})"))
    for f in failures:
        for rank, code in sorted((f.get("exit_codes") or {}).items()):
            label = {KILL_EXIT_CODE: "killed (137)",
                     DIVERGENCE_EXIT_CODE: "diverged (95)",
                     SPAWN_FAIL_EXIT_CODE: "spawn failed (96)",
                     WATCHDOG_EXIT_CODE: "watchdog exit (97)"}.get(
                         code, f"exit {code}")
            events.append(_event(None, rank, "exit", None,
                                 f"incarnation {f.get('incarnation')}: "
                                 f"rank {rank} {label}"))
        if f.get("reason"):
            events.append(_event(None, None, "failure", None,
                                 f"incarnation {f.get('incarnation')}: "
                                 f"{f['reason']}"))
    events.sort(key=lambda e: (e["t"] is None, e["t"] or 0.0))
    return events


# ======================================================== classification

def _memory_trend(fl: Optional[RankFlight]) -> Optional[dict]:
    """First->last memory readings over a rank's flight ring (the trend
    BEFORE the failure): per source (hbm/rss), first/last bytes and a
    coarse direction. None when no record carried a sample."""
    if fl is None:
        return None
    series: Dict[str, List[Tuple[int, int]]] = {"hbm": [], "rss": []}
    for rec in fl.iters:
        mem = rec.get("mem") or {}
        it = int(rec.get("iteration", -1))
        if mem.get("hbm_bytes_in_use") is not None:
            series["hbm"].append((it, int(mem["hbm_bytes_in_use"])))
        if mem.get("host_rss_bytes") is not None:
            series["rss"].append((it, int(mem["host_rss_bytes"])))
    out = {}
    for name, pts in series.items():
        if len(pts) < 1:
            continue
        first, last = pts[0][1], pts[-1][1]
        if len(pts) >= 2 and last > first * 1.05:
            direction = "rising"
        elif len(pts) >= 2 and last < first * 0.95:
            direction = "falling"
        else:
            direction = "flat"
        out[name] = {"first_bytes": first, "last_bytes": last,
                     "first_iteration": pts[0][0],
                     "last_iteration": pts[-1][0],
                     "samples": len(pts), "trend": direction}
    return out or None


def _iter_from_reason(reason: str) -> Optional[int]:
    m = re.search(r"iteration (\d+)", reason or "")
    return int(m.group(1)) if m else None


_NAN_TOKENS = ("non-finite", "nan", "check_numerics", "sentinel")
_OOM_TOKENS = ("resource_exhausted", "out of memory", "oom-exhausted",
               "resource exhausted")


def classify(flights: List[RankFlight], diags: List[dict],
             failures: List[dict]) -> Tuple[str, Optional[int],
                                            Optional[int], str, List[str]]:
    """Rank the evidence and return
    ``(verdict, rank, iteration, cause, evidence_lines)``.

    Priority (strongest evidence first): divergence (the gang's own
    majority vote names the corrupt rank) > kill (exit 137 / fault-kill
    flush) > OOM (ladder exhaustion / RESOURCE_EXHAUSTED error) > NaN
    (sentinel or check_numerics verdict) > hang (watchdog diagnosis —
    the FIRING rank is healthy; the suspect list names the stalled one)
    > unknown."""
    evidence: List[str] = []
    flight_by_rank = {fl.rank: fl for fl in flights}

    # every flush reason across ranks, with its rank
    flushes = [(fl.rank, fl_f.get("reason") or "", fl_f)
               for fl in flights for fl_f in fl.flushes]
    all_exits: Dict[int, int] = {}
    for f in failures:
        for rank, code in (f.get("exit_codes") or {}).items():
            all_exits.setdefault(int(rank), int(code))
    diag_pool = list(diags)
    for f in failures:
        diag_pool.extend(f.get("watchdog") or [])

    # ---- divergence
    div_diags = [d for d in diag_pool if d.get("kind") == "divergence"
                 or d.get("corrupt_ranks")]
    div_exits = [r for r, c in all_exits.items()
                 if c == DIVERGENCE_EXIT_CODE]
    if div_diags or div_exits:
        if div_diags:
            d = div_diags[0]
            corrupt = d.get("corrupt_ranks") or [d.get("rank")]
            rank = int(corrupt[0]) if corrupt else d.get("rank")
            it = d.get("iteration")
            evidence.append(
                f"divergence diagnosis: corrupt_ranks={corrupt} at "
                f"iteration {it} (majority fingerprint vote)")
        else:
            rank, it = div_exits[0], None
            evidence.append(f"rank {rank} exited with the divergence "
                            f"code ({DIVERGENCE_EXIT_CODE})")
        for r in div_exits:
            evidence.append(f"rank {r} exit code {DIVERGENCE_EXIT_CODE} "
                            f"(diverged)")
        cause = (f"rank {rank} held model state that diverged from the "
                 f"gang's majority (silent corruption); the integrity "
                 f"vote named it and it exited for a checkpoint restore")
        return "divergence", rank, it, cause, evidence

    # ---- kill
    kill_flush = [(r, reason) for r, reason, _ in flushes
                  if reason.startswith("fault-kill")]
    kill_exits = [r for r, c in all_exits.items() if c == KILL_EXIT_CODE]
    if kill_flush or kill_exits:
        if kill_flush:
            rank, reason = kill_flush[0]
            it = _iter_from_reason(reason)
            evidence.append(f"rank {rank} flight recorder flushed "
                            f"{reason!r}")
        else:
            rank, it = kill_exits[0], None
        for r in kill_exits:
            evidence.append(f"rank {r} exit code {KILL_EXIT_CODE} "
                            f"(SIGKILL shape: preemption / oom-kill / "
                            f"harness kill)")
        if it is None and rank in flight_by_rank:
            it = flight_by_rank[rank].last_iteration + 1
        cause = (f"rank {rank} was hard-killed"
                 + (f" at iteration {it}" if it is not None else "")
                 + " (exit 137 — the preemption/oom-kill shape)")
        return "kill", rank, it, cause, evidence

    # ---- oom
    oom_flush = [(r, reason) for r, reason, _ in flushes
                 if reason.startswith("oom-exhausted")
                 or (reason.startswith("train-error")
                     and any(tok in reason.lower()
                             for tok in _OOM_TOKENS))]
    oom_degr = []
    for fl in flights:
        for fl_f in fl.flushes:
            for d in (fl_f.get("health") or {}).get("degradations") or []:
                if "oom" in str(d.get("kind", "")):
                    oom_degr.append((fl.rank, d))
    if oom_flush:
        rank, reason = oom_flush[0]
        it = _iter_from_reason(reason)
        evidence.append(f"rank {rank} flushed {reason!r}")
        for r, d in oom_degr:
            line = (f"rank {r} degradation rung {d.get('level')}: "
                    f"{d.get('action')}")
            if d.get("predicted_hist_bytes"):
                line += (f" (traffic model predicted "
                         f"{d['predicted_hist_bytes']} bytes/pass)")
            evidence.append(line)
        cause = (f"rank {rank} exhausted device memory"
                 + (f" at iteration {it}" if it is not None else "")
                 + (f" after stepping down "
                    f"{len([1 for r, _ in oom_degr if r == rank])} "
                    f"degradation rung(s)" if oom_degr else ""))
        return "oom", rank, it, cause, evidence

    # ---- nan
    nan_flush = [(r, reason) for r, reason, _ in flushes
                 if reason.startswith("train-error")
                 and any(tok in reason.lower() for tok in _NAN_TOKENS)]
    nan_iters = [(fl.rank, rec) for fl in flights for rec in fl.iters
                 if str(rec.get("sentinel", "")).startswith("flags=")]
    if nan_flush or nan_iters:
        if nan_flush:
            rank, reason = nan_flush[0]
            it = _iter_from_reason(reason)
            evidence.append(f"rank {rank} flushed {reason!r}")
        else:
            rank, rec = nan_iters[0]
            it = rec.get("iteration")
            evidence.append(f"rank {rank} iteration {it} sentinel "
                            f"verdict {rec.get('sentinel')!r}")
        for r, rec in nan_iters:
            evidence.append(f"rank {r} iteration {rec.get('iteration')} "
                            f"carried sentinel {rec.get('sentinel')!r}")
        cause = (f"rank {rank} hit non-finite values"
                 + (f" at iteration {it}" if it is not None else "")
                 + " (NaN/Inf sentinel — check the objective, "
                   "learning_rate, and input features)")
        return "nan", rank, it, cause, evidence

    # ---- hang
    wd_diags = [d for d in diag_pool if d.get("kind") != "divergence"
                and (d.get("suspects") is not None
                     or d.get("phase") is not None)]
    wd_exits = [r for r, c in all_exits.items()
                if c == WATCHDOG_EXIT_CODE]
    if wd_diags or wd_exits:
        # the watchdog fires on HEALTHY ranks: the stalled rank is in
        # the suspect lists (majority across diags), or — fallback —
        # the rank whose flight ring stopped earliest
        from collections import Counter
        votes = Counter(s for d in wd_diags
                        for s in (d.get("suspects") or []))
        if votes:
            rank = int(votes.most_common(1)[0][0])
            evidence.append(f"watchdog suspect vote: {dict(votes)}")
        elif flights:
            # judge only each rank's NEWEST incarnation ring
            # (flight_by_rank keeps the last per rank — flights sort by
            # incarnation): a stale ring from a restarted-away
            # incarnation always stops early and would misname the rank
            rank = min(flight_by_rank.values(),
                       key=lambda fl: fl.last_iteration).rank
            evidence.append(
                f"no heartbeat suspects; rank {rank} has the earliest "
                f"last completed iteration "
                f"({flight_by_rank[rank].last_iteration})")
        else:
            rank = wd_diags[0].get("rank") if wd_diags else (
                wd_exits[0] if wd_exits else None)
        it = max((d.get("iteration") for d in wd_diags
                  if d.get("iteration") is not None), default=None)
        for d in wd_diags:
            evidence.append(
                f"rank {d.get('rank')} watchdog: phase "
                f"{d.get('phase')!r} stalled {d.get('elapsed')}s "
                f"(deadline {d.get('deadline')}s)")
        for r in wd_exits:
            evidence.append(f"rank {r} exit code {WATCHDOG_EXIT_CODE} "
                            f"(watchdog — symptom, not the stalled rank)")
        cause = (f"the gang stalled"
                 + (f" at iteration {it}" if it is not None else "")
                 + (f"; rank {rank} is the first-stalled suspect"
                    if rank is not None else ""))
        return "hang", rank, it, cause, evidence

    # ---- unknown
    spawn = [r for r, c in all_exits.items() if c == SPAWN_FAIL_EXIT_CODE]
    if spawn:
        evidence.append(f"rank(s) {spawn} never came up "
                        f"(exit {SPAWN_FAIL_EXIT_CODE})")
        return ("unknown", spawn[0], None,
                f"rank {spawn[0]}'s process failed to spawn", evidence)
    for f in failures:
        if f.get("reason"):
            evidence.append(f"incarnation {f.get('incarnation')}: "
                            f"{f['reason']}")
    return ("unknown", None, None,
            "no classifiable evidence found in the artifacts", evidence)


# =============================================================== report

@dataclass
class Postmortem:
    """The analyzed outcome: verdict + named rank + evidence + the
    merged timeline. ``to_json`` is the machine document, ``render``
    the human one."""
    verdict: str
    rank: Optional[int]
    iteration: Optional[int]
    cause: str
    evidence: List[str]
    timeline: List[dict]
    memory: Optional[dict]
    sources: Dict[str, Any]
    generated_at: float = 0.0
    schema: int = 1

    def to_json(self) -> Dict[str, Any]:
        return {"schema": self.schema, "generated_at": self.generated_at,
                "verdict": self.verdict, "rank": self.rank,
                "iteration": self.iteration, "cause": self.cause,
                "evidence": self.evidence, "memory": self.memory,
                "timeline": self.timeline, "sources": self.sources}

    def render(self, max_timeline: int = 40) -> str:
        lines = ["== lightgbm_tpu gang post-mortem =="]
        head = f"VERDICT: {self.verdict.upper()}"
        if self.rank is not None:
            head += f"  (rank {self.rank}"
            if self.iteration is not None:
                head += f", iteration {self.iteration}"
            head += ")"
        elif self.iteration is not None:
            head += f"  (iteration {self.iteration})"
        lines.append(head)
        lines.append(f"cause: {self.cause}")
        if self.evidence:
            lines.append("evidence:")
            lines.extend(f"  - {e}" for e in self.evidence)
        if self.memory:
            lines.append("memory trend before failure:")
            for name, tr in sorted(self.memory.items()):
                lines.append(
                    f"  - {name}: {tr['first_bytes'] / 1e9:.3f} GB "
                    f"(iter {tr['first_iteration']}) -> "
                    f"{tr['last_bytes'] / 1e9:.3f} GB "
                    f"(iter {tr['last_iteration']}), {tr['trend']} over "
                    f"{tr['samples']} samples")
        tl = self.timeline
        if tl:
            shown = tl[-max_timeline:]
            lines.append(f"timeline ({len(shown)} of {len(tl)} events, "
                         f"oldest first):")
            for e in shown:
                t = (time.strftime("%H:%M:%S", time.localtime(e["t"]))
                     if e.get("t") else "--:--:--")
                rank = f"rank {e['rank']}" if e.get("rank") is not None \
                    else "gang"
                lines.append(f"  {t} [{rank:>7}] {e['detail']}")
        src = self.sources
        lines.append(
            f"sources: {len(src.get('flights', []))} flight JSONL(s), "
            f"{len(src.get('diags', []))} diagnosis JSON(s), "
            f"{src.get('failures', 0)} supervisor failure record(s), "
            f"{len(src.get('manifests', []))} checkpoint manifest(s)")
        return "\n".join(lines) + "\n"


def analyze(dirs, checkpoint_dir: Optional[str] = None,
            failures=None) -> Postmortem:
    """Gather every artifact under ``dirs`` (a path or list of paths:
    the supervisor diag dir, telemetry dirs, ...), plus optional
    checkpoint manifests and a ``GangFailure`` history, and classify the
    failure. Never raises on malformed artifacts — they are skipped (and
    noted in ``sources``); an empty artifact set yields verdict
    ``unknown``."""
    if isinstance(dirs, str):
        dirs = [dirs]
    dirs = [d for d in (dirs or []) if d]
    # a checkpoint dir brings its supervisor_diag + telemetry subdirs
    # along for free (the default artifact layout)
    scan = list(dirs)
    if checkpoint_dir:
        for sub in ("supervisor_diag", "telemetry"):
            p = os.path.join(checkpoint_dir, sub)
            if os.path.isdir(p) and p not in scan:
                scan.append(p)
    flights = gather_flights(scan)
    diags = gather_diags(scan)
    fails = _normalize_failures(failures)
    manifests = gather_manifests(checkpoint_dir)
    verdict, rank, iteration, cause, evidence = classify(
        flights, diags, fails)
    timeline = build_timeline(flights, diags, fails, manifests)
    fl = next((f for f in reversed(flights) if f.rank == rank), None) \
        if rank is not None else (flights[-1] if flights else None)
    memory = _memory_trend(fl)
    parse_errors = [e for f in flights for e in f.errors]
    sources = {
        "dirs": scan, "checkpoint_dir": checkpoint_dir,
        "flights": [f.path for f in flights],
        "diags": [d.get("_path", "(from supervisor history)")
                  for d in diags],
        "failures": len(fails),
        "manifests": [m["_path"] for m in manifests],
    }
    if parse_errors:
        sources["parse_errors"] = parse_errors[:20]
    return Postmortem(verdict=verdict, rank=rank, iteration=iteration,
                      cause=cause, evidence=evidence, timeline=timeline,
                      memory=memory, sources=sources,
                      generated_at=time.time())


def write_report(pm: Postmortem, directory: str) -> str:
    """Write the machine JSON + human text reports into ``directory``
    and return the JSON path (what the supervisor embeds in
    ``SupervisorReport.postmortem``)."""
    os.makedirs(directory, exist_ok=True)
    from .utils.atomic_write import atomic_write_text
    json_path = os.path.join(directory, REPORT_JSON)
    atomic_write_text(json_path, json.dumps(pm.to_json(), indent=1,
                                            sort_keys=True,
                                            default=str) + "\n")
    atomic_write_text(os.path.join(directory, REPORT_TEXT), pm.render())
    return json_path
