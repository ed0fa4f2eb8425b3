"""The deployed serve process on one schedule, traced or not: what the
tracer and the watchdog cost the serve loop and its POSTs.

The schedule (``chip_smoke.py`` phase 28's): the oracle sidecar on the
card, ``python -m kueue_tpu_torch.serve`` with the sidecar on a copy of
the seeded ``serve_world.FULL`` journal (1,000 ClusterQueues x 50,000
workloads), its seeded backlog drained first; then one SSE client joins
``/events`` and the first ``ARRIVALS`` arrivals are POSTed at
``serve_world.FULL["rate"]`` (200 a second) until the loop is idle
again. ``run`` drives it once with the given serve flags and returns
what it saw; ``main`` runs it untraced (no flags) and traced
(``TRACE_FLAGS``) in turns, untraced, traced, traced, untraced per
repeat, holds every run to the first run's final state (tracing decides
nothing), and prints per run the POST p50 and p95, the wall seconds per
device cycle of the arrivals and the serve loop's own split (its
SIGTERM line's ``loop_s``), then one JSON line, which ``--out`` also
writes:

    python3 -m kueue_tpu_torch.bench.serve_traced [--repeats 1]
        [--out serve_traced.json]

Runs the sidecar and the serve process on CUDA, in
``kueue_tpu_torch/_build/serve_traced``; needs ``nvidia-smi`` for the
card's name.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import threading
import time
from pathlib import Path

from kueue_tpu_torch.bench import serve_world as sw

# The traced arm's serve flags.
TRACE_FLAGS = ("--trace", "64", "--watchdog-deadline", "30",
               "--watchdog-hang", "120")
# The arrivals POSTed (the first quarter of serve_world.FULL's).
ARRIVALS = 250


def _pct(values, q):
    v = sorted(values)
    return v[min(len(v) - 1, int(len(v) * q))]


def sse_reader(url, out: list, ready: threading.Event) -> None:
    """Read ``url``'s /events into ``out`` as (kind, data) until the
    server closes the stream."""
    import http.client

    host, port = url.split("//", 1)[1].rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=3600)
    conn.request("GET", "/events")
    resp = conn.getresponse()
    ready.set()
    kind = None
    try:
        for raw in resp.fp:
            line = raw.decode()
            if line.startswith("event:"):
                kind = line.split(":", 1)[1].strip()
            elif line.startswith("data:"):
                out.append((kind, json.loads(line.split(":", 1)[1])))
    except OSError:
        pass


def _stop_all(procs) -> None:
    for p in procs:
        if p.p.poll() is None:
            p.p.kill()
            p.p.wait()


def run(seed, work, bodies, flags=TRACE_FLAGS, name="serve",
        device="cuda") -> dict:
    """One run of the schedule on a copy of ``seed`` at
    ``work/<name>.jsonl`` with the serve ``flags``, the sidecar and the
    serve process on ``device``. Returns the journal's
    path, the POSTs (``posted``: codes and latencies), the ``/oracle``
    views after the backlog (``backlog``) and at the end (``idle``),
    ``drain_s`` from the first POST to idle, the final ``views``
    (``/workloads``, ``/debug/dump``), ``/debug/trace`` when the
    client joined (``traced0``, None untraced) and at the end
    (``trace``), ``/debug/perf``, ``/debug/slo``, the bytes of ``/`` and
    ``/dashboard`` (``pages``), the exit codes and SIGTERM lines of the
    serve process and the sidecar, and the SSE ``stream``."""
    path = Path(work) / f"{name}.jsonl"
    shutil.copy(seed, path)
    traced = "--trace" in flags
    procs = []
    stream: list = []
    try:
        side, port = sw.start_sidecar(device)
        procs.append(side)
        serve, url, boot = sw.start_serve(path, f"127.0.0.1:{port}", device,
                                          extra=flags)
        procs.append(serve)
        # The seeded backlog first: its 49,937 admissions, ~1,000 a
        # cycle, overflow any one client's bounded queue (by design: a
        # slow client drops events and never holds a cycle), so the
        # client joins once they are done and stays for the arrivals.
        backlog = sw.wait_idle(url, 900, dump_every=15.0)["oracle"]
        ready = threading.Event()
        reader = threading.Thread(target=sse_reader,
                                  args=(url, stream, ready), daemon=True)
        reader.start()
        if not ready.wait(60):
            raise TimeoutError("/events did not answer")
        time.sleep(0.2)
        traced0 = (sw.get_json(url, "/debug/trace")["cyclesTraced"]
                   if traced else None)
        t0 = time.perf_counter()
        posted = sw.post_arrivals(url, bodies, sw.FULL["rate"])
        idle = sw.wait_idle(url, 900, dump_every=15.0)
        drain_s = time.perf_counter() - t0
        views = (sw.get_json(url, "/workloads"),
                 sw.get_json(url, "/debug/dump"))
        trace = sw.get_json(url, "/debug/trace")
        perf = sw.get_json(url, "/debug/perf")
        slo = sw.get_json(url, "/debug/slo")
        pages = [sw.get_text(url, p)[2] for p in ("/", "/dashboard")]
        rc, last = serve.stop()
        side_rc, side_last = side.stop()
        reader.join(30)
    finally:
        _stop_all(procs)
    return dict(path=path, boot=boot, posted=posted, backlog=backlog,
                idle=idle["oracle"], drain_s=drain_s, views=views,
                traced0=traced0, trace=trace, perf=perf, slo=slo,
                pages=pages, rc=rc, last=last, side_rc=side_rc,
                side_last=side_last, stream=stream)


def summary(r: dict) -> dict:
    """A run's POST p50, p95 and maximum, its arrival device cycles and
    wall per device cycle, the median and 95th percentile of the traced
    cycles' own durations on the stream (``dur_ms`` of their
    ``cycle_trace`` events; None untraced), and its serve loop's split
    over the whole process."""
    lat = r["posted"]["latencies"]
    cycles = r["last"]["cycles_on_device"] - r["backlog"]["cyclesOnDevice"]
    durs = [float(d["detail"].split("dur_ms=")[1].split()[0]) / 1e3
            for k, d in r["stream"] if k == "cycle_trace"]
    return dict(post_p50_s=_pct(lat, 0.5), post_p95_s=_pct(lat, 0.95),
                post_max_s=max(lat), device_cycles=cycles,
                drain_s=r["drain_s"],
                wall_per_device_cycle_s=r["drain_s"] / cycles,
                traced_cycle_p50_s=_pct(durs, 0.5) if durs else None,
                traced_cycle_p95_s=_pct(durs, 0.95) if durs else None,
                loop_s=r["last"]["loop_s"])


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repeats", type=int, default=1)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    work = sw.REPO / "kueue_tpu_torch" / "_build" / "serve_traced"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    rows = []
    try:
        seed = work / "seed.jsonl"
        sw.seed_journal(seed, sw.FULL)
        bodies = sw.arrival_bodies(sw.FULL)[:ARRIVALS]
        want = None
        arms = ("untraced", "traced", "traced", "untraced") * args.repeats
        for k, arm in enumerate(arms):
            r = run(seed, work, bodies,
                    TRACE_FLAGS if arm == "traced" else (), f"run{k}")
            if set(r["posted"]["codes"]) != {201} or (r["rc"],
                                                     r["side_rc"]) != (0, 0):
                raise AssertionError(
                    f"{arm}: POST codes {sorted(set(r['posted']['codes']))}"
                    f", exit codes {r['rc']}, {r['side_rc']}")
            got = sw.final_state(*r["views"])
            if want is not None and got != want:
                raise AssertionError(f"{arm}: final state {got}, the first "
                                     f"run's {want}")
            want = want or got
            r["path"].unlink()
            row = dict(arm=arm, **summary(r))
            rows.append(row)
            loop = ",".join(f"{part}={v:.3f}"
                            for part, v in row["loop_s"].items())
            print(f"{arm} POST p50_s={row['post_p50_s']:.5f} "
                  f"p95_s={row['post_p95_s']:.5f} "
                  f"max_s={row['post_max_s']:.5f} "
                  f"wall_per_device_cycle_s="
                  f"{row['wall_per_device_cycle_s']:.5f} "
                  f"device_cycles={row['device_cycles']} "
                  f"drain_s={row['drain_s']:.3f} traced cycle "
                  f"p50_s={row['traced_cycle_p50_s']} "
                  f"p95_s={row['traced_cycle_p95_s']} loop_s {loop} "
                  f"final checksum=0x{got['checksum']:08x} | {card}",
                  flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    doc = {"card": card, "rows": rows}
    print(json.dumps(doc))
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=1)


if __name__ == "__main__":
    main()
