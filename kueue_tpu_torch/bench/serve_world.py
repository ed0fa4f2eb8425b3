"""The deployed control plane's world and its drive: ``python -m
kueue_tpu_torch.serve`` rebuilding a seeded journal, with its device
cycles in the oracle sidecar, while job controllers keep creating
workloads over HTTP (``chip_smoke.py`` phases 19 to 21).

The world is ``cycle_latency``'s (``engine_worlds.FULL``:
``baseline_like()``, 200 cohorts x 5 = 1,000 ClusterQueues, 50,000
pending workloads, built as ``build_cycle_engine`` builds it but
without an oracle) plus one ClusterQueue ``arrivals`` in a cohort of its
own, with a LocalQueue and quota for every arrival. ``seed_journal``
writes it to a journal (``attach_new_journal``: the flavor, 201
cohorts, 1,001 ClusterQueues and LocalQueues, 50,000 workloads). The
arrivals (``arrivals``: 1,000 workloads of ``baseline_like``'s 70/20/10
mix of 1, 5 and 20 cpu, ``random.Random(41)``, fixed creation times)
are POSTed while the loop runs, at 200 a second. They sit in a root of
their own, so when they land changes no decision of the seeded roots,
and each fits; the final state is the same whenever they land.

Every step is a function: the world and journal builders take a ``Kit``
(``engine_worlds.port_kit`` by default; the parity tests pass the JAX
package's), the process helpers start and stop the sidecar, the serve
process, HA replicas and read replicas and read their lines, and the
view helpers poll the HTTP endpoint. Each child runs in a session and
process group of its own and is registered from its spawn until it is
reaped: a start helper whose wait raises kills its child first,
``stop_all`` kills every child still registered, and ``survivors``
lists from ``/proc`` any process still alive below this one or in a
session one of its children led. ``checksum`` pins a final state: the
crc32 over the sorted workload keys, each with its ClusterQueue, its
flavors, QuotaReserved and Admitted, computed from GET ``/workloads``
and ``/debug/dump`` (or the same views computed in-process).
"""

from __future__ import annotations

import http.client
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path

from kueue_tpu_torch.bench import engine_worlds as ew

REPO = Path(__file__).resolve().parents[2]

FULL = dict(n_cohorts=200, cqs_per_cohort=5, n_workloads=50_000,
            arrivals=1_000, rate=200.0)
SMALL = dict(n_cohorts=4, cqs_per_cohort=5, n_workloads=1_000,
             arrivals=40, rate=200.0)

ARRIVALS = "arrivals"  # the ClusterQueue, its cohort and its LocalQueue
_SIZES = ((1000, 0.70), (5000, 0.20), (20000, 0.10))


def arrivals(config, kit=None) -> list:
    """The workloads POSTed while the loop runs, in posting order."""
    t = (kit or ew.port_kit("cpu")).types
    rng = random.Random(41)
    out = []
    for i in range(config["arrivals"]):
        r = rng.random()
        acc = 0.0
        size = _SIZES[-1][0]
        for sz, frac in _SIZES:
            acc += frac
            if r < acc:
                size = sz
                break
        out.append(t.Workload(
            name=f"arrival-{i}", queue_name=ARRIVALS,
            priority=rng.choice([0, 0, 0, 50, 100]),
            creation_time=1e6 + i,
            pod_sets=(t.PodSet("main", 1, {"cpu": size}),)))
    return out


def build_world(config, kit=None):
    """The seeded engine, without an oracle: ``build_cycle_engine``'s
    order (flavors, cohorts, ClusterQueues, LocalQueues, then the
    workloads 0.0001 s apart on the engine clock), the arrivals'
    cohort, ClusterQueue and LocalQueue after the scenario's."""
    kit = kit or ew.port_kit("cpu")
    t = kit.types
    scen = kit.scenario.baseline_like(
        n_cohorts=config["n_cohorts"],
        cqs_per_cohort=config["cqs_per_cohort"],
        n_workloads=config["n_workloads"])
    quota = sum(wl.pod_sets[0].requests["cpu"]
                for wl in arrivals(config, kit))
    eng = kit.engine(False)
    for rf in scen.flavors:
        eng.create_resource_flavor(rf)
    for co in scen.cohorts + [t.Cohort(ARRIVALS)]:
        eng.create_cohort(co)
    for cq in scen.cluster_queues + [t.ClusterQueue(
            name=ARRIVALS, cohort=ARRIVALS,
            resource_groups=(t.ResourceGroup(
                ("cpu",), (t.FlavorQuotas(
                    "default", {"cpu": t.ResourceQuota(quota)}),)),))]:
        eng.create_cluster_queue(cq)
    for lq in scen.local_queues + [t.LocalQueue(ARRIVALS, "default",
                                                ARRIVALS)]:
        eng.create_local_queue(lq)
    for wl in scen.workloads:
        eng.clock += 0.0001
        eng.submit(wl)
    return eng


def seed_journal(path, config, kit=None, journal_module=None) -> dict:
    """Write the seeded world to a new journal at ``path`` with
    ``journal_module.attach_new_journal`` (the port's store/journal.py
    by default). Returns its records and bytes."""
    if journal_module is None:
        from kueue_tpu_torch.store import journal as journal_module
    eng = build_world(config, kit)
    journal = journal_module.attach_new_journal(eng, str(path))
    journal.close()
    with open(path, "rb") as fh:
        records = sum(1 for _ in fh)
    return {"records": records, "bytes": os.path.getsize(path)}


def arrival_bodies(config, kit=None, serde=None) -> list:
    """The POST bodies of the arrivals (serde-tagged JSON)."""
    if serde is None:
        from kueue_tpu_torch.api import serde
    return [json.dumps(serde.to_jsonable(wl)).encode()
            for wl in arrivals(config, kit)]


# -- the final state --

def checksum(workloads_view, dump_view) -> int:
    """crc32 of the final state from the ``/workloads`` and
    ``/debug/dump`` views: the sorted workload keys, each with its
    ClusterQueue, its flavor/resource pairs, QuotaReserved and
    Admitted."""
    admitted = dump_view["admitted"]
    rows = []
    for w in sorted(workloads_view,
                    key=lambda w: (w["namespace"], w["name"])):
        key = f"{w['namespace']}/{w['name']}"
        a = admitted.get(key)
        rows.append((key, a["clusterQueue"] if a else "",
                     tuple(sorted(a["usage"])) if a else (),
                     w["status"] in ("Admitted", "QuotaReserved"),
                     w["status"] == "Admitted"))
    return zlib.crc32(repr(rows).encode())


def final_state(workloads_view, dump_view) -> dict:
    """What a run is pinned by: the final state's ``checksum``, the
    workloads holding a quota reservation (``admitted``), and of them
    the arrivals."""
    admitted = dump_view["admitted"]
    return {"checksum": checksum(workloads_view, dump_view),
            "admitted": len(admitted),
            "arrivals_admitted": sum(1 for a in admitted.values()
                                     if a["clusterQueue"] == ARRIVALS)}


def engine_views(engine, dump_state, kueuectl) -> tuple:
    """The (``/workloads``, ``/debug/dump``) views of an in-process
    engine, through JSON as the endpoint serves them; ``dump_state``
    and ``kueuectl`` are either package's."""
    return (json.loads(json.dumps(
                kueuectl.Kueuectl(engine).list_workloads())),
            json.loads(json.dumps(dump_state(engine))))


def drain_in_process(engine, max_cycles=100_000) -> int:
    """schedule_once until an idle cycle; returns the cycles run."""
    for n in range(max_cycles):
        if engine.schedule_once() is None:
            return n + 1
    raise AssertionError(f"not idle after {max_cycles} cycles")


def wire_bytes(config, device="cpu") -> dict:
    """The sidecar frames of one in-process drain of the world with all
    its arrivals: the port's engine through a RemoteExecutor to an
    OracleServer on ``device`` in a thread. Returns the bytes each way
    of the first call and per call on average, and the calls. Frame
    sizes follow from the cycle's inputs, whatever the device."""
    from kueue_tpu_torch.oracle.service import OracleServer

    server = OracleServer(device=device)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        eng = build_world(config, ew.port_kit("cpu"))
        eng.attach_oracle(device="cpu", remote_address=server.address)
        for wl in arrivals(config):
            eng.submit(wl)
        ex = eng.oracle.executor
        eng.schedule_once()
        first = (ex.bytes_sent, ex.bytes_received)
        drain_in_process(eng)
        ex.close()
    finally:
        server.close()
    return {"first_sent": first[0], "first_received": first[1],
            "sent_per_call": ex.bytes_sent / ex.calls,
            "received_per_call": ex.bytes_received / ex.calls,
            "calls": ex.calls}


# -- processes --

# Every child this module starts, by pid, from its spawn until it is
# reaped, and the session of each child ever started (a child leads a
# session of its own, so its pid names the session). stop_all and
# survivors read them: no child is lost when a start helper raises.
_LIVE: dict = {}
_SESSIONS: set = set()
_LIVE_LOCK = threading.Lock()


class Proc:
    """A child process in a session and process group of its own,
    registered as soon as it is spawned, with its stdout and stderr read
    into lists by threads (its pipes never fill)."""

    def __init__(self, argv, env=None):
        self.argv = argv
        self.p = subprocess.Popen(
            [sys.executable, "-u", *argv], cwd=REPO,
            env=env if env is not None else child_env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True)
        with _LIVE_LOCK:
            _LIVE[self.p.pid] = self
            _SESSIONS.add(self.p.pid)
        self.out: list[str] = []
        self.err: list[str] = []
        self._cv = threading.Condition()
        for stream, sink in ((self.p.stdout, self.out),
                             (self.p.stderr, self.err)):
            threading.Thread(target=self._read, args=(stream, sink),
                             daemon=True).start()

    @property
    def pid(self) -> int:
        return self.p.pid

    def _read(self, stream, sink) -> None:
        for line in stream:
            with self._cv:
                sink.append(line.rstrip("\n"))
                self._cv.notify_all()

    def wait_line(self, needle: str, timeout: float) -> str:
        """The first stdout line holding ``needle``; raises if the
        process exits or ``timeout`` seconds pass first."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                for line in self.out:
                    if needle in line:
                        return line
                if self.p.poll() is not None:
                    raise RuntimeError(
                        f"{self.argv[1]} exited {self.p.returncode} before "
                        f"{needle!r}: {self.tail()}")
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"no {needle!r} from {self.argv[1]} "
                                       f"in {timeout} s: {self.tail()}")
                self._cv.wait(min(left, 0.5))

    def tail(self) -> str:
        return " | ".join(self.err[-15:] + self.out[-5:])

    def _signal_group(self, sig) -> None:
        try:
            os.killpg(self.p.pid, sig)
        except (ProcessLookupError, PermissionError):
            pass  # the group is gone

    def stop(self, sig=signal.SIGTERM, timeout: float = 60.0):
        """Send ``sig`` to the process group and wait; after ``timeout``
        seconds SIGKILL the group. The process is always reaped, and
        anything left in its group is SIGKILLed after it. Returns (exit
        code, the last JSON line of stdout or None)."""
        if self.p.poll() is None:
            self._signal_group(sig)
        try:
            rc = self.p.wait(timeout)
        except subprocess.TimeoutExpired:
            self._signal_group(signal.SIGKILL)
            rc = self.p.wait()
        self._signal_group(signal.SIGKILL)
        with _LIVE_LOCK:
            _LIVE.pop(self.p.pid, None)
        time.sleep(0.1)  # let the reader threads drain the pipes
        last = None
        for line in self.out:
            if line.startswith("{"):
                last = json.loads(line)
        return rc, last

    def kill(self) -> int:
        """SIGKILL the group and reap; returns the exit code."""
        return self.stop(signal.SIGKILL, timeout=30.0)[0]

    def rss_kb(self) -> int:
        """The live process's resident memory (VmRSS), in kB."""
        with open(f"/proc/{self.p.pid}/status") as fh:
            for line in fh:
                key, _, value = line.partition(":")
                if key == "VmRSS":
                    return int(value.split()[0])
        raise RuntimeError(f"no VmRSS for pid {self.p.pid}")


def started(proc: Proc, wait):
    """``wait()`` (a start helper's wait for its child's lines); if it
    raises, the child is killed and reaped before the error goes on."""
    try:
        return wait()
    except BaseException:
        proc.kill()
        raise


def stop_all() -> list:
    """SIGKILL and reap every child still registered; returns their
    argv."""
    with _LIVE_LOCK:
        procs = list(_LIVE.values())
    for proc in procs:
        proc.kill()
    return [proc.argv for proc in procs]


def _stat(pid: str):
    """(state, parent pid, session) of a /proc entry, or None."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            data = fh.read()
    except OSError:
        return None
    fields = data[data.rindex(")") + 2:].split()
    return fields[0], int(fields[1]), int(fields[3])


def survivors() -> list:
    """The live processes (zombies included) whose parent chain reaches
    this process or whose session is one a child of this module
    started: [(pid, argv)], from /proc."""
    root = os.getpid()
    table = {}
    for name in os.listdir("/proc"):
        if name.isdigit() and int(name) != root:
            st = _stat(name)
            if st is not None:
                table[int(name)] = st
    out = []
    for pid, (_state, ppid, sid) in sorted(table.items()):
        chain, up = set(), ppid
        while up not in (0, 1, root) and up in table and up not in chain:
            chain.add(up)
            up = table[up][1]
        if up == root or sid in _SESSIONS:
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as fh:
                    argv = fh.read().split(b"\0")
            except OSError:
                argv = []
            out.append((pid, " ".join(a.decode(errors="replace")
                                      for a in argv if a)))
    return out


def kill_survivors(found) -> None:
    """SIGKILL each (pid, argv) of ``survivors`` and reap it when it is
    a child of this process."""
    for pid, _argv in found:
        try:
            os.kill(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:
            pass


def child_env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO), **extra)
    return env


def start_sidecar(device, port=0, fault=None, env=None,
                  timeout=120.0) -> tuple:
    """``python -m kueue_tpu_torch.oracle.service`` on ``device``;
    returns (Proc, port) once it listens."""
    argv = ["-m", "kueue_tpu_torch.oracle.service", "--port", str(port),
            "--device", device]
    if fault:
        argv += ["--fault", fault]
    proc = Proc(argv, env)
    line = started(proc, lambda: proc.wait_line("listening on", timeout))
    return proc, int(line.split("listening on ")[1].split()[0]
                     .rsplit(":", 1)[1])


def _serve_argv(journal, oracle, device, extra) -> list:
    return ["-m", "kueue_tpu_torch.serve", "--journal", str(journal),
            "--oracle", oracle, "--device", device,
            "--http", "127.0.0.1:0", "--tick", "0.05", *extra]


def _base_url(line: str) -> str:
    return "http://" + line.split("serving on ")[1].split()[0]


def start_serve(journal, oracle, device, env=None, timeout=600.0,
                extra=()) -> tuple:
    """``python -m kueue_tpu_torch.serve`` on a journal, with the serve
    arguments ``extra`` after the usual ones; returns (Proc, base URL,
    boot) once it serves, ``boot`` holding the records, bytes, rebuild
    seconds, recovery source and base and suffix records it printed and
    ``wall_s`` from spawn to serving."""
    t0 = time.perf_counter()
    proc = Proc(_serve_argv(journal, oracle, device, extra), env)

    def wait():
        return (proc.wait_line("rebuilt ", timeout).split(),
                proc.wait_line("serving on ", timeout))

    rebuilt, line = started(proc, wait)
    wall = time.perf_counter() - t0
    tagged = dict(w.split("=", 1) for w in rebuilt[8:])
    return proc, _base_url(line), {
        "records": int(rebuilt[1]), "bytes": int(rebuilt[3].lstrip("(")),
        "rebuild_s": float(rebuilt[6]), "source": tagged["source"],
        "base": int(tagged["base"]), "suffix": int(tagged["suffix"]),
        "wall_s": wall}


def start_ha(journal, identity, oracle, device, lease_duration,
             fault=None, timeout=600.0, extra=()) -> tuple:
    """``python -m kueue_tpu_torch.serve --ha`` as replica ``identity``
    on a journal and its ``<journal>.lease``, with the serve arguments
    ``extra`` after the usual ones; returns (Proc, base URL, wall
    seconds from spawn to serving) once it serves as a follower (its
    read model built)."""
    t0 = time.perf_counter()
    argv = ["--ha", "--replica-id", identity, "--lease",
            f"{journal}.lease", "--lease-duration", str(lease_duration),
            *extra]
    if fault:
        argv += ["--fault", fault]
    proc = Proc(_serve_argv(journal, oracle, device, argv))
    line = started(proc, lambda: (proc.wait_line("serving on ", timeout),
                                  proc.wait_line("ha: replica=",
                                                 timeout))[0])
    return proc, _base_url(line), time.perf_counter() - t0


def start_read_replica(journal, identity, device,
                       timeout=600.0) -> tuple:
    """``python -m kueue_tpu_torch.serve --read-replica`` on a journal;
    returns (Proc, base URL, wall seconds from spawn to serving)."""
    t0 = time.perf_counter()
    proc = Proc(_serve_argv(journal, "off", device,
                            ["--read-replica", "--replica-id", identity]))
    line = started(proc, lambda: proc.wait_line("read replica serving on ",
                                                timeout))
    return proc, _base_url(line), time.perf_counter() - t0


# -- HTTP --

def _conn(url: str, timeout: float) -> http.client.HTTPConnection:
    hostport = url.split("://", 1)[1]
    host, _, port = hostport.rpartition(":")
    return http.client.HTTPConnection(host, int(port), timeout=timeout)


def get_json(url: str, path: str, timeout: float = 120.0):
    c = _conn(url, timeout)
    try:
        c.request("GET", path)
        r = c.getresponse()
        body = r.read()
        if r.status != 200:
            raise RuntimeError(f"GET {path}: {r.status} {body[:200]!r}")
        return json.loads(body)
    finally:
        c.close()


def get_text(url: str, path: str, timeout: float = 120.0) -> tuple:
    """(body text, wall seconds, bytes) of one GET answered 200."""
    t0 = time.perf_counter()
    c = _conn(url, timeout)
    try:
        c.request("GET", path)
        r = c.getresponse()
        body = r.read()
        if r.status != 200:
            raise RuntimeError(f"GET {path}: {r.status} {body[:200]!r}")
    finally:
        c.close()
    return body.decode(), time.perf_counter() - t0, len(body)


def metric_lines(text: str, family: str) -> list:
    """The sorted sample lines of one family of a Prometheus text
    exposition (``family`` without the ``kueue_tpu_`` prefix)."""
    name = "kueue_tpu_" + family
    return sorted(ln for ln in text.split("\n")
                  if ln.startswith((name + "{", name + " ")))


def metric_values(text: str, family: str) -> dict:
    """{label values tuple: value} of one family's samples."""
    out = {}
    for ln in metric_lines(text, family):
        head, _, value = ln.rpartition(" ")
        labels = head[head.index("{") + 1:-1] if "{" in head else ""
        out[tuple(part.split("=", 1)[1].strip('"')
                  for part in labels.split(",") if part)] = float(value)
    return out


def metrics_digest(text: str, family: str) -> int:
    """crc32 of one family's sorted sample lines."""
    return zlib.crc32("\n".join(metric_lines(text, family)).encode())


def post(url: str, path: str, body: bytes, timeout: float = 120.0):
    """(status, parsed body) of one POST."""
    c = _conn(url, timeout)
    try:
        c.request("POST", path, body=body,
                  headers={"Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, json.loads(r.read() or b"null")
    finally:
        c.close()


def post_arrivals(url: str, bodies, rate: float, workers: int = 8) -> dict:
    """POST every body to /workloads, the i-th at ``i / rate`` seconds
    after the start, from ``workers`` threads. Returns the status codes
    (0 where the connection failed: the process is down) and the
    latencies in seconds, in body order."""
    n = len(bodies)
    codes = [0] * n
    lat = [0.0] * n
    t0 = time.monotonic()

    def worker(k: int) -> None:
        for i in range(k, n, workers):
            delay = t0 + i / rate - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            s = time.perf_counter()
            try:
                codes[i], _ = post(url, "/workloads", bodies[i])
            except (OSError, http.client.HTTPException):
                codes[i] = 0
            lat[i] = time.perf_counter() - s

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {"codes": codes, "latencies": lat,
            "seconds": time.monotonic() - t0}


def wait_idle(url: str, timeout: float, dump_every: float = 2.0,
              settle: float = 1.0, until=None, held: int = 0) -> dict:
    """Poll ``/oracle`` (every 0.1 s) and ``/debug/dump`` (every
    ``dump_every`` s, and once more as soon as no device cycle ran for
    ``settle`` seconds) until the ClusterQueues hold no active pending
    workload but the ``held`` ones (held back by a future requeue time)
    and no device cycle ran for ``settle`` seconds (requests wait out a
    running cycle, so a dump sees the queues between cycles);
    ``until(oracle_stats)``, when given, is called on every poll and
    must also hold. Returns the last ``/oracle`` and
    ``/debug/dump`` views, the ``lastCyclePhases`` each dump sampled
    (``phase_samples``) and those of the ``/oracle`` polls that saw a
    new device cycle (``oracle_samples``)."""
    deadline = time.monotonic() + timeout
    samples = []
    oracle_samples = []
    last_dump = -1e9
    stable_since = None
    prev = None
    while True:
        st = get_json(url, "/oracle")
        busy = st["cyclesOnDevice"]
        now = time.monotonic()
        if busy != prev:
            if prev is not None:
                oracle_samples.append(st["lastCyclePhases"])
            prev, stable_since = busy, now
        settled = now - stable_since >= settle
        if (now - last_dump >= dump_every
                or (settled and last_dump < stable_since + settle)):
            dump = get_json(url, "/debug/dump")
            last_dump = now
            if dump["lastCyclePhases"]:
                samples.append(dump["lastCyclePhases"])
            active = sum(len(q["active"]) for q in dump["queues"].values())
            if (active == held and settled
                    and (until is None or until(st))):
                return {"oracle": st, "dump": dump, "phase_samples": samples,
                        "oracle_samples": oracle_samples}
        if now > deadline:
            raise TimeoutError(f"serve loop not idle after {timeout} s: {st}")
        time.sleep(0.1)


class ReadPoller(threading.Thread):
    """Queries pending and quota through a ``readplane.ReadFrontend``
    that knows only the read replicas ``bases``, every ``every``
    seconds, until ``halt`` is set: each answer with its wall time and
    its seconds (``answers``), each failure's repr (``errors``)."""

    KINDS = ("pending", "quota")

    def __init__(self, bases, every: float):
        from kueue_tpu_torch.readplane import ReadFrontend

        super().__init__(daemon=True)
        self.fe = ReadFrontend(list(bases), timeout=60.0)
        self.every = every
        self.answers: list = []
        self.errors: list = []
        self.halt = threading.Event()

    def run(self) -> None:
        while not self.halt.is_set():
            for kind in self.KINDS:
                t0 = time.perf_counter()
                try:
                    out = self.fe.query(kind)
                except Exception as e:  # noqa: BLE001 — recorded
                    self.errors.append(repr(e))
                    continue
                self.answers.append((time.time(), kind, out,
                                     time.perf_counter() - t0))
            self.halt.wait(self.every)

    def stop(self) -> None:
        self.halt.set()
        self.join(timeout=120)


# -- the journal, read directly --

def journal_state(path) -> dict:
    """Per workload key in a journal (the port's replay, a torn final
    line skipped): whether its last record is admitted, how many times
    its records went from not admitted to admitted, and the keys whose
    records carry more than one Admitted transition time (admitted
    twice). When the
    journal has a valid checkpoint, the records read are its base and
    the suffix past it (``store/checkpoint.recover_records``): retention
    may have deleted the segments before it, and the base's record of a
    key counts as its first."""
    from kueue_tpu_torch.store.checkpoint import recover_records_at
    from kueue_tpu_torch.store.journal import read_chain

    base, suffix, meta = recover_records_at(str(path))
    records = base + suffix if meta is not None else read_chain(str(path))
    admitted: dict[str, bool] = {}
    transitions: dict[str, int] = {}
    admit_times: dict[str, set] = {}
    for rec in records:
        if rec["kind"] != "workload" or rec["op"] != "apply":
            continue
        obj = rec["obj"]
        key = f"{obj['namespace']}/{obj['name']}"
        conds = obj["status"]["conditions"]
        times = {c["last_transition_time"] for c in conds.values()
                 if c["type"]["v"] == "Admitted" and c["status"]} \
            if isinstance(conds, dict) else set()
        now = bool(times)
        if now:
            admit_times.setdefault(key, set()).update(times)
        if now and not admitted.get(key, False):
            transitions[key] = transitions.get(key, 0) + 1
        admitted[key] = now
    return {"admitted": {k for k, v in admitted.items() if v},
            "transitions": transitions,
            "admitted_twice": sorted(k for k, t in admit_times.items()
                                     if len(t) > 1)}


def torn_tail(path) -> bool:
    """True when the journal's last line is incomplete or does not
    parse."""
    data = Path(path).read_bytes()
    if not data:
        return False
    if not data.endswith(b"\n"):
        return True
    last = data[:-1].rsplit(b"\n", 1)[-1]
    try:
        json.loads(last)
    except ValueError:
        return True
    return False
