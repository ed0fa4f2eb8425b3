"""The federation world of ``chip_smoke.py`` phase 34: HA cells behind
the federation dispatcher, under the federation chaos chain.

Each cell is ``python -m kueue_tpu_torch.serve --ha --oracle local`` on
the device, with its own journal and lease. Every journal starts from
one world definition and no workload: serve_world's world
(``baseline_like``'s 200 cohorts x 5 = 1,000 ClusterQueues, their quotas
sized for its 50,000 workloads, which are not submitted) plus the
``arrivals`` cohort,
ClusterQueue and LocalQueue, whose quota is the sum of every arrival's
request, so any one cell can admit every arrival (``bench.py``'s
``federation_failover`` sizing). The stream is serve_world's
``arrivals`` (its 70/20/10 mix of 1, 5 and 20 cpu, ``random.Random(41)``)
at ``arrivals`` workloads, POSTed at ``rate`` a second:

  1. the first ``federate`` go through a ``serve --federate`` process
     over the cells, its loop ticking every ``FEDERATE_TICK`` seconds
     (``federate_faults``, when given, SIGKILL a cell and
     restart it on its own journal at those arrival ordinals); its
     ``/cells`` and ``/debug/federation`` are read, it is driven until
     every route it holds is admitted, and SIGTERM ends it (rc 0);
  2. the rest go through an in-process ``FederationDispatcher`` built
     cold from the same route journal, with the ``EventAggregator``
     feeding its hub, under ``FederationChaosSchedule(seed, cells,
     workloads=N)`` (``chaos_seed``: the first seed whose chain holds
     all four kinds), ticked ``TICK_EVERY`` seconds after the end of
     its last tick while the arrivals are posted (each tick probes every
     cell and may poll their workload lists: ticking after every submit
     would hold the stream below its rate) and every ``TICK`` seconds
     after, confirming admissions every ``CONFIRM_TICKS`` ticks, so that
     a cell dies holding admissions the dispatcher has not confirmed
     yet, as a cell does between two confirm polls: ``cell-sigkill`` SIGKILLs the victim,
     ``dispatcher-crash`` raises at the dispatcher module's
     ``HANDOFF_CRASH_HOOK`` and the dispatcher is rebuilt from its
     journal, ``partition`` cuts a survivor off (``PartitionedTransport``)
     for ``arg`` dispatcher ticks, and ``zombie-rejoin`` restarts the
     victim on its own journal and port, under a new replica identity.
     The arrivals go on being posted while the zombie boots (a thread
     starts it).

``check`` holds a run to the invariants: every route admitted; the
union of the cells' admitted sets (each a cold ``rebuild_engine`` of the
cell's journal, whose admitted-state digest must equal the live cell's)
equal to the submitted set and pairwise disjoint; the zombie's
revocations above 0 (when the run asks for it) and the ``federation_*``
series equal to the routes; survivor events relayed through the
aggregated hub after the kill; and, on the device, each cell process
that SIGTERM ended with its heads launches equal to its dispatched
device calls. Every process goes through ``serve_world.Proc`` and is
stopped in a ``finally``.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path

from kueue_tpu_torch.bench import engine_worlds as ew
from kueue_tpu_torch.bench import serve_world as sw

FULL = dict(n_cohorts=200, cqs_per_cohort=5, n_workloads=50_000,
            cells=("cell-a", "cell-b", "cell-c"), arrivals=3_000,
            federate=1_000, rate=200.0, federate_faults=(), lease=3.0,
            converge_s=300.0, need_revocations=True)
# The CPU test's: two cells behind the ``serve --federate`` process, one
# SIGKILLed and restarted as a zombie while the arrivals go through it.
SMALL = dict(n_cohorts=4, cqs_per_cohort=5, n_workloads=1_000,
             cells=("cell-a", "cell-b"),
             arrivals=40, federate=40, rate=80.0,
             federate_faults=(("cell-sigkill", "cell-a", 14),
                              ("zombie-rejoin", "cell-a", 28)),
             lease=1.5, converge_s=120.0, need_revocations=False)

KINDS = ("cell-sigkill", "dispatcher-crash", "partition", "zombie-rejoin")
# Seconds between the ``--federate`` process's ticks (serve's default),
# between two ticks of the in-process dispatcher while the arrivals are
# posted, and between two ticks otherwise; the in-process dispatcher's
# confirm poll every CONFIRM_TICKS ticks (module docstring).
FEDERATE_TICK = 0.25
TICK_EVERY = 0.25
TICK = 0.05
CONFIRM_TICKS = 8


class InjectedDispatcherCrash(Exception):
    """Raised at ``HANDOFF_CRASH_HOOK``: the dispatcher dies after the
    route intent is durable and before the handoff leaves it."""


def chaos_seed(cells, workloads: int) -> int:
    """The first seed from 1 whose federation chain holds every kind."""
    from kueue_tpu_torch.replay.faults import FederationChaosSchedule

    seed = 1
    while {e.kind for e in FederationChaosSchedule(
            seed, cells, workloads=workloads).events()} != set(KINDS):
        seed += 1
    return seed


def arrivals(config) -> list:
    return sw.arrivals(config, ew.port_kit("cpu"))


def seed_world(path, config) -> dict:
    """The world definition, no workload, written to a new journal at
    ``path``. Returns its records and bytes."""
    from kueue_tpu_torch.store.journal import attach_new_journal

    kit = ew.port_kit("cpu")
    t = kit.types
    scen = kit.scenario.baseline_like(
        n_cohorts=config["n_cohorts"],
        cqs_per_cohort=config["cqs_per_cohort"],
        n_workloads=config["n_workloads"])
    quota = sum(wl.pod_sets[0].requests["cpu"] for wl in arrivals(config))
    eng = kit.engine(False)
    journal = attach_new_journal(eng, str(path))
    for rf in scen.flavors:
        eng.create_resource_flavor(rf)
    for co in scen.cohorts + [t.Cohort(sw.ARRIVALS)]:
        eng.create_cohort(co)
    for cq in scen.cluster_queues + [t.ClusterQueue(
            name=sw.ARRIVALS, cohort=sw.ARRIVALS,
            resource_groups=(t.ResourceGroup(("cpu",), (t.FlavorQuotas(
                "default", {"cpu": t.ResourceQuota(quota)}),)),))]:
        eng.create_cluster_queue(cq)
    for lq in scen.local_queues + [t.LocalQueue(sw.ARRIVALS, "default",
                                                sw.ARRIVALS)]:
        eng.create_local_queue(lq)
    journal.close()
    with open(path, "rb") as fh:
        records = sum(1 for _ in fh)
    return {"records": records, "bytes": Path(path).stat().st_size}


def pct(values, q: float) -> float:
    if not values:
        return 0.0
    v = sorted(values)
    return v[min(len(v) - 1, int(len(v) * q))]


class Cells:
    """The cell processes: start (on a fixed port for a restart), kill,
    stop; every one a ``serve_world.Proc`` of ``serve --ha``."""

    def __init__(self, config, work: Path, device: str):
        self.config, self.work, self.device = config, work, device
        self.procs: dict = {}
        self.urls: dict = {}
        self.incarnation: dict = {}
        self.ended: dict = {}  # name -> [(rc, last JSON line)]
        self.lock = threading.Lock()

    def journal(self, name: str) -> Path:
        return self.work / f"{name}.jsonl"

    def start(self, name: str) -> float:
        """Start (or restart, on its port) cell ``name``; returns the
        seconds from spawn to its ``role=leader`` line."""
        n = self.incarnation[name] = self.incarnation.get(name, -1) + 1
        ident = name if n == 0 else f"{name}-r{n}"
        extra = ()
        if name in self.urls:
            extra = ("--http", "127.0.0.1:" + self.urls[name]
                     .rsplit(":", 1)[1])
        t0 = time.perf_counter()
        proc, url, _wall = sw.start_ha(
            self.journal(name), ident, "local", self.device,
            self.config["lease"], extra=extra)
        with self.lock:
            self.procs[name] = proc
            self.urls[name] = url
        sw.started(proc, lambda: proc.wait_line("ha: role=leader", 600))
        return time.perf_counter() - t0

    def kill(self, name: str) -> None:
        with self.lock:
            proc = self.procs.pop(name)
        proc.kill()

    def stop_all(self) -> None:
        with self.lock:
            procs = dict(self.procs)
            self.procs.clear()
        for name, proc in procs.items():
            self.ended.setdefault(name, []).append(
                proc.stop(timeout=60.0))


def _post_all(url: str, bodies: list, rate: float) -> dict:
    """POST every body to the dispatcher at ``rate`` a second; bodies
    refused (503 with no healthy cell, or no answer) go again after a
    second, until every one is accepted (200, 201 or 202). Returns the
    first pass's codes and latencies and the retries."""
    first = sw.post_arrivals(url, bodies, rate)
    todo = [i for i, c in enumerate(first["codes"])
            if c not in (200, 201, 202)]
    retries = 0
    deadline = time.monotonic() + 120
    while todo:
        if time.monotonic() > deadline:
            raise AssertionError(f"{len(todo)} arrivals never accepted")
        time.sleep(1.0)
        again = sw.post_arrivals(url, [bodies[i] for i in todo], rate)
        retries += len(todo)
        todo = [i for i, c in zip(todo, again["codes"])
                if c not in (200, 201, 202)]
    return dict(first, retries=retries)


def _wait_federate(url: str, total: int, timeout: float) -> dict:
    deadline = time.monotonic() + timeout
    while True:
        st = sw.get_json(url, "/debug/federation")
        if st["routes"].get("admitted", 0) == total and \
                all(c["up"] for c in st["cells"]):
            return st
        if time.monotonic() > deadline:
            raise AssertionError(f"federate: routes never all admitted: "
                                 f"{json.dumps(st)[:2000]}")
        time.sleep(0.2)


def _federate_part(config, cells, work, bodies, out, say) -> None:
    """Part 1: the arrivals through a ``serve --federate`` process."""
    spec = ",".join(f"{n}={cells.urls[n]}" for n in config["cells"])
    proc = sw.Proc(["-m", "kueue_tpu_torch.serve", "--federate", spec,
                    "--journal", str(work / "routes.jsonl"), "--http",
                    "127.0.0.1:0", "--tick", str(FEDERATE_TICK)])
    try:
        line = sw.started(proc, lambda: proc.wait_line(
            "federation dispatcher serving on ", 120))
        url = sw._base_url(line)
        deadline = time.monotonic() + 60
        while not all(c["up"] for c in
                      sw.get_json(url, "/cells")["cells"]):
            if time.monotonic() > deadline:
                raise AssertionError("federate: cells never all up")
            time.sleep(0.1)
        faults = sorted(config["federate_faults"], key=lambda f: f[2])
        start, lat, codes, spent = 0, [], [], 0.0
        for kind, name, at in faults + [(None, None, len(bodies) + 1)]:
            seg = bodies[start:at - 1]
            if seg:
                got = _post_all(url, seg, config["rate"])
                lat += got["latencies"]
                codes += got["codes"]
                spent += got["seconds"]
            start = max(start, at - 1)
            if kind == "cell-sigkill":
                cells.kill(name)
                out["killed"].append(name)
            elif kind == "zombie-rejoin":
                out["rejoin_boot_s"] = cells.start(name)
        out["post_latencies"] = lat
        out["post_seconds"] = spent
        out["post_codes"] = {c: codes.count(c) for c in sorted(set(codes))}
        out["cells_view"] = sw.get_json(url, "/cells")
        t0 = time.monotonic()
        st = _wait_federate(url, len(bodies), config["converge_s"])
        out["federate_converge_s"] = time.monotonic() - t0
        out["federate_status"] = {k: st[k] for k in (
            "tick", "handoffs", "redispatches", "revocations", "routes")}
        out["debug_federation"] = bool(st["cells"])
    finally:
        out["federate_rc"], out["federate_last"] = proc.stop(timeout=60.0)
    say(f"  federate: {len(bodies)} arrivals, codes {out['post_codes']}, "
        f"POST p50_s={pct(out['post_latencies'], 0.5):.4f} "
        f"p95_s={pct(out['post_latencies'], 0.95):.4f}, routes "
        f"{out['federate_status']['routes']}, revocations "
        f"{out['federate_status']['revocations']}, rc "
        f"{out['federate_rc']}")


def _chaos_part(config, cells, work, wls, out, say) -> None:
    """Part 2: the arrivals through an in-process dispatcher under the
    federation chaos chain."""
    from kueue_tpu_torch.federation import dispatcher as dmod
    from kueue_tpu_torch.federation.aggregator import EventAggregator
    from kueue_tpu_torch.federation.cells import CellHandle, HTTPCellTransport
    from kueue_tpu_torch.federation.dispatcher import (
        ACKED,
        ADMITTED,
        FederationDispatcher,
    )
    from kueue_tpu_torch.metrics.registry import MetricsRegistry
    from kueue_tpu_torch.replay.faults import (
        FederationChaosSchedule,
        PartitionedTransport,
    )
    from kueue_tpu_torch.visibility.fanout import FanoutHub

    names = tuple(config["cells"])
    seed = out["seed"] = chaos_seed(names, len(wls))
    events = FederationChaosSchedule(seed, names,
                                     workloads=len(wls)).events()
    out["events"] = [f"{e.kind}@{e.at}" + (f":{e.cell}" if e.cell else "")
                     + (f":{e.arg}" if e.arg else "") for e in events]
    by_at: dict = {}
    crash_at = None
    for e in events:
        if e.kind == "dispatcher-crash":
            crash_at = e.at
        else:
            by_at.setdefault(e.at, []).append(e)
    registry = MetricsRegistry()
    hub = FanoutHub(shards=2)
    proxies = {n: PartitionedTransport(HTTPCellTransport(
        cells.urls[n], timeout=3.0)) for n in names}
    journal = str(work / "routes.jsonl")
    state = {"d": None, "ticks": 0, "heal_at": None, "partitioned": None,
             "revocations": 0, "redispatches": 0, "rebuilds": 0}

    def build():
        state["d"] = FederationDispatcher(
            journal, [CellHandle(n, proxies[n], probe_interval_ticks=1,
                                 breaker_threshold=2,
                                 breaker_cooldown_ticks=2)
                      for n in names], metrics=registry, hub=hub,
            confirm_interval_ticks=CONFIRM_TICKS)
        return state["d"]

    def crash():
        d = state["d"]
        state["revocations"] += d.revocations
        state["redispatches"] += d.redispatches
        d.journal.close()
        state["rebuilds"] += 1
        build()

    def hook(ordinal, key):
        if ordinal == crash_at:
            dmod.HANDOFF_CRASH_HOOK = None
            out["crashed_at_key"] = key
            raise InjectedDispatcherCrash(key)

    relayed: list = []
    client = hub.subscribe(depth=100_000)
    stop_drain = threading.Event()

    def drain_hub():
        import queue

        while not stop_drain.is_set():
            try:
                item = client.get(timeout=0.2)
            except queue.Empty:
                continue
            if isinstance(item, tuple):
                relayed.append((time.time(), item[0], item[1]))

    kill = {"t": None, "victim": None, "pending": set()}
    redispatch: dict = {}

    def observe(now):
        d = state["d"]
        for key in list(kill["pending"]):
            rec = d.routes.get(key)
            if rec is not None and rec["cell"] != kill["victim"] and \
                    rec["state"] in (ACKED, ADMITTED):
                redispatch[key] = now - kill["t"]
                kill["pending"].discard(key)

    tick_s = out["tick_s"] = []

    def tick():
        s = time.perf_counter()
        try:
            state["d"].tick(time.time())
        except InjectedDispatcherCrash:
            crash()
        tick_s.append(time.perf_counter() - s)
        state["ticks"] += 1
        if state["heal_at"] is not None and state["ticks"] >= state["heal_at"]:
            proxies[state["partitioned"]].partitioned = False
            state["heal_at"] = None
        observe(time.time())

    rejoin = {}

    def start_zombie(name):
        try:
            rejoin["boot_s"] = cells.start(name)
            rejoin["ready"] = time.time()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            rejoin["error"] = e

    def fire(e):
        d = state["d"]
        if e.kind == "cell-sigkill":
            kill["victim"], kill["t"] = e.cell, time.time()
            kill["pending"] = {k for k, rec in d.routes.items()
                               if rec["cell"] == e.cell
                               and rec["state"] != ADMITTED}
            cells.kill(e.cell)
            out["killed"].append(e.cell)
        elif e.kind == "partition":
            proxies[e.cell].partitioned = True
            state["partitioned"] = e.cell
            state["heal_at"] = state["ticks"] + e.arg
        elif e.kind == "zombie-rejoin":
            rejoin["thread"] = threading.Thread(target=start_zombie,
                                                args=(e.cell,))
            rejoin["t"] = time.time()
            rejoin["thread"].start()

    d = build()
    agg = EventAggregator(list(d.cells.values()), hub,
                          reconnect_seconds=0.5)
    agg.start()
    drainer = threading.Thread(target=drain_hub, daemon=True)
    drainer.start()
    submit_s = []
    t_start = time.monotonic()
    try:
        deadline = time.monotonic() + 60
        while not all(c.up for c in state["d"].cells.values()):
            if time.monotonic() > deadline:
                raise AssertionError("chaos: cells never all up")
            tick()
            time.sleep(TICK)
        dmod.HANDOFF_CRASH_HOOK = hook if crash_at is not None else None
        t0 = time.monotonic()
        out["chaos_wait_s"] = t0 - t_start
        last_tick = time.monotonic()
        for i, wl in enumerate(wls, start=1):
            for e in by_at.get(i, ()):
                fire(e)
            delay = t0 + (i - 1) / config["rate"] - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            sub_deadline = time.monotonic() + 120
            while True:
                s = time.perf_counter()
                try:
                    verdict = state["d"].submit(wl, time.time())
                except InjectedDispatcherCrash:
                    crash()
                    continue  # the journaled intent deduplicates it
                if verdict["code"] in (200, 201, 202):
                    submit_s.append(time.perf_counter() - s)
                    break
                if time.monotonic() > sub_deadline:
                    raise AssertionError(f"chaos: {wl.key} never "
                                         f"accepted: {verdict}")
                tick()
                last_tick = time.monotonic()
                time.sleep(TICK)
            if time.monotonic() - last_tick >= TICK_EVERY:
                tick()
                last_tick = time.monotonic()
        t_converge = time.monotonic()
        out["chaos_post_s"] = t_converge - t0
        if "thread" in rejoin:
            while rejoin["thread"].is_alive():
                tick()
                time.sleep(TICK)
            if "error" in rejoin:
                raise rejoin["error"]
        total = config["arrivals"]
        deadline = time.monotonic() + config["converge_s"]
        reconciled = None
        while True:
            tick()
            d = state["d"]
            victim = d.cells.get(kill["victim"]) if kill["victim"] else None
            if reconciled is None and victim is not None and \
                    "ready" in rejoin and victim.up and \
                    not getattr(victim, "needs_reconcile", False):
                reconciled = time.time() - rejoin["ready"]
            if d.route_counts().get(ADMITTED, 0) == total and \
                    all(c.up for c in d.cells.values()):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"chaos: never converged: "
                                     f"{json.dumps(d.status())[:3000]}")
            time.sleep(TICK)
        d = state["d"]
        out["chaos_converge_s"] = time.monotonic() - t_converge
        out["zombie_reconcile_s"] = reconciled
        out["zombie_boot_s"] = rejoin.get("boot_s")
        out["rebuilds"] = state["rebuilds"]
        out["revocations"] = state["revocations"] + d.revocations
        out["redispatches"] = state["redispatches"] + d.redispatches
        out["route_counts"] = d.route_counts()
        out["status"] = d.status()
        out["redispatch_s"] = sorted(redispatch.values())
        out["redispatch_pending"] = len(kill["pending"])
        out["submit_s"] = submit_s
        out["partition_dropped"] = sum(p.dropped for p in proxies.values())
        fam = registry.counter("federation_revocations_total")
        out["revocations_metric"] = int(sum(fam.values.values()))
        routes_g = registry.gauge("federation_routes").values
        out["routes_metric"] = {k[0]: int(v) for k, v in routes_g.items()
                                if v}
        out["cell_up_metric"] = {k[0]: v for k, v in
                                 registry.gauge("federation_cell_up")
                                 .values.items()}
        survivors = set(names) - {kill["victim"]}
        out["relayed_after_kill"] = sum(
            1 for ts, _kind, data in relayed
            if kill["t"] is not None and ts > kill["t"]
            and _cell_of(data) in survivors)
        out["relayed"] = len(relayed)
        out["aggregator"] = agg.stats()
    finally:
        dmod.HANDOFF_CRASH_HOOK = None
        # The tailers are daemon threads; stop only sets their flag.
        agg.stop()
        stop_drain.set()
        hub.unsubscribe(client)
        hub.close()
        if state["d"] is not None:
            state["d"].close()
        if "thread" in rejoin:
            rejoin["thread"].join()
    say(f"  chaos: seed {seed} {out['events']}, {len(wls)} arrivals, "
        f"dispatcher rebuilds {out['rebuilds']}, redispatches "
        f"{out['redispatches']}, revocations {out['revocations']}, "
        f"partition drops {out['partition_dropped']}, relayed "
        f"{out['relayed']} ({out['relayed_after_kill']} survivor events "
        f"after the kill)")


def _cell_of(data: str):
    try:
        body = json.loads(data)
    except ValueError:
        return None
    return body.get("cell") if isinstance(body, dict) else None


def run(config, device=None, work=None, say=print) -> dict:
    """Drive the federation world of ``config`` with its cells on
    ``device`` (CUDA unless "cpu"), in ``work`` (a fresh directory;
    removed after). Returns what ``check`` reads and the phase prints."""
    from kueue_tpu_torch.api import serde

    device = device or "cuda"
    work = Path(work)
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    wls = arrivals(config)
    out = {"killed": [], "submitted": sorted(wl.key for wl in wls)}
    cells = Cells(config, work, device)
    try:
        world = work / "world.jsonl"
        out["world"] = seed_world(world, config)
        for name in config["cells"]:
            shutil.copy(world, cells.journal(name))
        boots = {}

        def boot(name):
            try:
                boots[name] = cells.start(name)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                boots[name] = e

        threads = [threading.Thread(target=boot, args=(n,))
                   for n in config["cells"]]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for v in boots.values():
            if isinstance(v, BaseException):
                raise v
        out["boot_s"] = boots
        n1 = config["federate"]
        bodies = [json.dumps(serde.to_jsonable(wl)).encode()
                  for wl in wls[:n1]]
        _federate_part(config, cells, work, bodies, out, say)
        if len(wls) > n1:
            _chaos_part(config, cells, work, wls[n1:], out, say)
        live = {}
        for name in config["cells"]:
            live[name] = sw.get_json(cells.urls[name], "/debug/ha")
        cells.stop_all()
        out["ended"] = {n: [(rc, last) for rc, last in runs]
                        for n, runs in cells.ended.items()}
        out["cells"] = _cold_rebuilds(config, cells, live)
    finally:
        cells.stop_all()
        shutil.rmtree(work, ignore_errors=True)
    return out


def _cold_rebuilds(config, cells, live) -> dict:
    from kueue_tpu_torch.ha.digest import admitted_state_digest
    from kueue_tpu_torch.store.journal import rebuild_engine

    got = {}
    for name in config["cells"]:
        t0 = time.perf_counter()
        eng = rebuild_engine(str(cells.journal(name)), device="cpu")
        got[name] = {
            "live_digest": live[name].get("stateDigest"),
            "cold_digest": admitted_state_digest(eng),
            "admitted": sorted(
                k for k, w in eng.workloads.items()
                if w.status.admission is not None and not w.is_finished),
            "rebuild_s": time.perf_counter() - t0,
            "revoked": live[name].get("revoked"),
            "route_epoch": live[name].get("routeEpoch")}
        eng.journal.close()
    return got


def dispatched(last: dict) -> int:
    """The device calls a cell process dispatched, from its SIGTERM
    line: device cycles less used speculations, plus every
    speculation."""
    ps = last.get("pipeline_stats") or {}
    return last["cycles_on_device"] - ps.get("used", 0) + \
        ps.get("speculated", 0)


def check(config, r: dict, device: str) -> list:
    """The invariants of a run (module docstring); raises
    AssertionError on the first broken one. Returns the lines to
    print."""
    total = config["arrivals"]
    submitted = set(r["submitted"])
    if len(submitted) != total:
        raise AssertionError(f"{len(submitted)} keys for {total} arrivals")
    if r["federate_rc"] != 0:
        raise AssertionError(f"federate process exited {r['federate_rc']}")
    if not r.get("debug_federation") or not r["cells_view"]["cells"]:
        raise AssertionError("/cells or /debug/federation did not answer")
    if total > config["federate"]:
        if r["route_counts"] != {"admitted": total}:
            raise AssertionError(f"routes {r['route_counts']}")
        if set(e.split("@")[0] for e in r["events"]) != set(KINDS):
            raise AssertionError(f"chain {r['events']}")
        if r["routes_metric"] != {"admitted": total}:
            raise AssertionError(f"federation_routes {r['routes_metric']}")
        if r["revocations_metric"] != r["revocations"]:
            raise AssertionError(
                f"federation_revocations_total {r['revocations_metric']} "
                f"!= {r['revocations']}")
        if set(r["cell_up_metric"].values()) != {1.0}:
            raise AssertionError(f"federation_cell_up {r['cell_up_metric']}")
        if r["relayed_after_kill"] <= 0:
            raise AssertionError("no survivor event relayed after the kill")
        if r["redispatch_pending"]:
            raise AssertionError(f"{r['redispatch_pending']} routes of the "
                                 "victim never re-acked on a survivor")
        revocations = r["revocations"]
    else:
        if r["federate_status"]["routes"] != {"admitted": total}:
            raise AssertionError(f"routes {r['federate_status']['routes']}")
        revocations = r["federate_status"]["revocations"]
    if config["need_revocations"] and revocations <= 0:
        raise AssertionError("the zombie revoked nothing")
    union: set = set()
    dupes: set = set()
    for name, c in r["cells"].items():
        if c["live_digest"] != c["cold_digest"]:
            raise AssertionError(f"{name}: live digest {c['live_digest']} "
                                 f"!= cold rebuild {c['cold_digest']}")
        keys = set(c["admitted"])
        dupes |= union & keys
        union |= keys
    if union != submitted or dupes:
        raise AssertionError(
            f"global reconciliation: lost {sorted(submitted - union)[:20]} "
            f"extra {sorted(union - submitted)[:20]} duplicates "
            f"{sorted(dupes)[:20]}")
    lines = []
    for name, runs in r["ended"].items():
        for rc, last in runs:
            if rc != 0 or last is None:
                raise AssertionError(f"{name}: SIGTERM gave rc {rc}")
            want = dispatched(last)
            if device != "cpu" and last["heads_launches"] != want:
                raise AssertionError(
                    f"{name} ({last['identity']}): heads launched "
                    f"{last['heads_launches']} times for {want} dispatched "
                    f"device calls")
            lines.append(f"  {last['identity']}: rc 0, heads_launches="
                         f"{last['heads_launches']} dispatched={want} "
                         f"cycles_on_device={last['cycles_on_device']} "
                         f"pipeline_stats={last['pipeline_stats']}")
    spread = {n: len(c["admitted"]) for n, c in r["cells"].items()}
    lines.append(f"  union == submitted ({total}), pairwise disjoint, "
                 f"spread {spread}; revocations {revocations}; live "
                 f"digests == cold rebuilds")
    return lines
