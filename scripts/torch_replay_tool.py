#!/usr/bin/env python
"""Replay inspection tool of the PyTorch port — desync post-mortems from
recorded input streams.

    python scripts/torch_replay_tool.py info match.npz
    python scripts/torch_replay_tool.py checksums match.npz --model box_game [--every 10] [--device cuda]
    python scripts/torch_replay_tool.py diff a.npz b.npz
    python scripts/torch_replay_tool.py merge-reports peer_a.json peer_b.json

The subcommands and flags are ``scripts/replay_tool.py``'s, over the port's
``session/replay.py`` and ``telemetry`` (recordings and forensics reports
are in the JAX package's formats, so either package's files load here).
`checksums` re-simulates the recording deterministically on ``--device``
(default: ``BGT_PLATFORM`` / ``JAX_PLATFORMS``, else CUDA) and prints
per-frame checksums (compare outputs across builds/machines to locate a
divergence frame); `diff` compares two recordings' input streams (e.g. the
two peers' recordings of the same match — the first differing frame is
where their realities split); `merge-reports` frame-aligns two peers'
desync forensics reports (``telemetry/forensics.py`` JSON files, either
package's) and prints the first divergent frame with both sides' rollback
and phase context — run it FIRST, before any re-simulation."""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402


def load(path):
    from bevy_ggrs_tpu_torch.session.replay import InputRecorder

    return InputRecorder.load(path)


def cmd_info(args):
    rec = load(args.recording)
    frames = sorted(rec.frames)
    print(f"players:      {rec.num_players}")
    print(f"input shape:  {rec.input_shape} {rec.input_dtype}")
    print(f"frames:       {len(frames)}"
          + (f" ({frames[0]}..{frames[-1]})" if frames else ""))
    gaps = [f for f in range(frames[0], frames[-1]) if f not in rec.frames] if frames else []
    print(f"gaps:         {len(gaps)}" + (f" first at {gaps[0]}" if gaps else ""))


def cmd_checksums(args):
    from bevy_ggrs_tpu_torch import GgrsRunner, models, telemetry
    from bevy_ggrs_tpu_torch.session.replay import ReplaySession
    from bevy_ggrs_tpu_torch.utils.platform import apply_platform_env

    device = args.device if args.device is not None else apply_platform_env()

    if args.telemetry_out or args.trace_out:
        telemetry.enable()
    rec = load(args.recording)
    app = getattr(models, args.model).make_app(num_players=rec.num_players,
                                               device=device)
    # bit-faithful replay requires the recorded canonical program config
    app.canonical_depth = rec.canonical_depth
    app.canonical_branches = rec.canonical_branches
    runner = GgrsRunner(app, ReplaySession(rec))
    if args.phase_breakdown:
        fr = telemetry.flight_recorder()
        # size the ring to the whole replay so the percentiles are exact
        fr.set_maxlen(max(fr.maxlen, len(rec.frames) + 16))
        fr.clear()
    while not runner.session.finished:
        runner.tick()
        if runner.frame % args.every == 0:
            print(f"frame {runner.frame}: "
                  f"{runner._world_checksum.to_int():#018x}")
    print(f"final frame {runner.frame}: "
          f"{runner._world_checksum.to_int():#018x}")
    if args.phase_breakdown:
        print("per-phase latency over the replay (ms/tick, exact):")
        print(telemetry.format_phase_table(
            telemetry.phase_breakdown(fr.snapshot("tick"))
        ))
    if args.telemetry_out:
        n = telemetry.export_jsonl(args.telemetry_out)
        print(f"telemetry timeline: {n} events -> {args.telemetry_out}")
    if args.trace_out:
        n = telemetry.write_trace(args.trace_out)
        print(f"chrome trace: {n} events -> {args.trace_out} "
              f"(load in ui.perfetto.dev)")


def cmd_diff(args):
    a, b = load(args.a), load(args.b)
    frames = sorted(set(a.frames) | set(b.frames))
    diverged = False
    for f in frames:
        va, vb = a.frames.get(f), b.frames.get(f)
        if va is None or vb is None:
            print(f"frame {f}: only in {'b' if va is None else 'a'}")
            diverged = True
        elif not np.array_equal(va, vb):
            print(f"frame {f}: a={va.tolist()} b={vb.tolist()}")
            diverged = True
    print("recordings identical" if not diverged else "recordings DIFFER")
    return 1 if diverged else 0


def cmd_merge_reports(args):
    from bevy_ggrs_tpu_torch.telemetry import merge_reports

    m = merge_reports(args.a, args.b)
    first = m["first_divergent_frame"]
    as_json = getattr(args, "json", False)
    if getattr(args, "trace_out", None):
        from bevy_ggrs_tpu_torch.telemetry import merge_report_traces

        with open(args.a) as f:
            ra = json.load(f)
        with open(args.b) as f:
            rb = json.load(f)
        merged = merge_report_traces(ra, rb)
        with open(args.trace_out, "w") as f:
            json.dump(merged, f, default=repr)
        n = len(merged["traceEvents"])
        print(f"merged chrome trace: {n} events -> {args.trace_out} "
              f"(cross-peer flow arrows; load in ui.perfetto.dev)",
              file=sys.stderr if as_json else sys.stdout)
    if as_json:
        print(json.dumps(m, indent=2, default=repr))
        return 1 if first is not None else 0
    print(f"a: {m['a']}")
    print(f"b: {m['b']}")
    print(f"overlapping checksummed frames: {m['common_frames']}")
    if first is None:
        print("no divergent frame in the overlapping window — the split "
              "predates both reports' retained checksums; rerun with a "
              "denser DesyncDetection interval")
        return 0
    at = m["checksums_at_divergence"] or {}
    print(f"FIRST DIVERGENT FRAME: {first}")
    if at.get("a") is not None or at.get("b") is not None:
        print(f"  checksum a: {at.get('a'):#018x}" if at.get("a") is not None
              else "  checksum a: (absent)")
        print(f"  checksum b: {at.get('b'):#018x}" if at.get("b") is not None
              else "  checksum b: (absent)")
    if m["divergent_frames"]:
        tail = m["divergent_frames"][:8]
        print(f"  divergent frames ({len(m['divergent_frames'])}): {tail}"
              + (" ..." if len(m["divergent_frames"]) > 8 else ""))
    if m["component_diff"]:
        print(f"  diverged components: {', '.join(m['component_diff'])}")
    for side in ("a", "b"):
        rbs = [r for r in m["rollbacks"][side]
               if r.get("to_frame") is not None
               and abs(r["to_frame"] - first) <= 8]
        if rbs:
            print(f"  {side} rollbacks near frame {first}:")
            for r in rbs[-4:]:
                print(f"    -> {r.get('to_frame')} depth={r.get('depth')} "
                      f"handle={r.get('handle')} "
                      f"lateness={r.get('lateness')} "
                      f"kind={r.get('cause_kind')}")
        ctx = m["tick_context"][side]
        if ctx:
            print(f"  {side} tick context ({len(ctx)} entries):")
            for e in ctx[-4:]:
                print(f"    frame={e.get('frame')} "
                      f"wall_ms={e.get('wall_ms')} "
                      f"rollbacks={e.get('rollbacks')} "
                      f"phases={e.get('phases')}")
    return 1


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("info")
    p.add_argument("recording")
    p = sub.add_parser("checksums")
    p.add_argument("recording")
    p.add_argument("--model", default="box_game")
    p.add_argument("--every", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="torch device of the re-simulation (default: "
                        "BGT_PLATFORM / JAX_PLATFORMS, else cuda)")
    p.add_argument("--telemetry-out", default=None, metavar="PATH",
                   help="enable telemetry and write the replay's timeline "
                        "(spans, rollbacks, dispatches) as JSONL")
    p.add_argument("--phase-breakdown", action="store_true",
                   help="print per-phase p50/p95/p99 latency over the "
                        "replay (exact values from the flight recorder; "
                        "needs no telemetry)")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="enable telemetry and write the replay as Chrome-"
                        "trace JSON (load in ui.perfetto.dev)")
    p = sub.add_parser("diff")
    p.add_argument("a")
    p.add_argument("b")
    p = sub.add_parser(
        "merge-reports",
        help="frame-align two desync forensics reports; exit 1 on divergence",
    )
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--json", action="store_true",
                   help="emit the merge result (first_divergent_frame, "
                        "component_diff, rollbacks, tick context) as JSON "
                        "on stdout instead of the text summary; exit codes "
                        "unchanged (1 on divergence)")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="write both reports' embedded trace slices as ONE "
                        "clock-aligned Chrome trace with cross-peer flow "
                        "arrows from the blamed peer's input send to the "
                        "victim's rollback (load in ui.perfetto.dev)")
    args = ap.parse_args()
    rc = {
        "info": cmd_info,
        "checksums": cmd_checksums,
        "diff": cmd_diff,
        "merge-reports": cmd_merge_reports,
    }[args.cmd](args)
    raise SystemExit(rc or 0)


if __name__ == "__main__":
    main()
