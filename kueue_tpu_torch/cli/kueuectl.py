"""kueuectl-equivalent CLI for the standalone engine: the port of
``kueue_tpu/cli/kueuectl.py``.

Reference: cmd/kueuectl (app/cmd.go:79): create {cq,lq,rf}, list
{clusterqueues,localqueues,workloads,resourceflavors,pods}, get,
describe, stop/resume {workload,clusterqueue,localqueue}, delete,
version, and the engine's own verbs: record and replay (the flight
recorder), explain (why is a workload pending), slo, status (an HA
replica, live or offline), cells (a federation dispatcher, live or
offline) and trace export.

The CLI operates on an Engine instance (in-process, ``run``) or on a
journal (``main --journal PATH``, which rebuilds the engine and journals
the mutations back). ``main --device cuda|cpu`` puts the engine it
builds, and the engines ``replay`` builds, on that device (CUDA unless
the CPU is asked for, as ``serve --device``); ``run`` replays on the
given engine's device. ``record`` on a journal runs the host path, as
in the JAX package: the rebuilt engine has no oracle attached.

Left out by design: ``lint``, which drives the repository's static
analyzer (``tools/graftlint``, whose validators and sanitizer import the
JAX package), and ``sim``, which comes with the simulator's port. Neither
subparser is registered.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

from kueue_tpu_torch.api.types import (
    ClusterQueue,
    FlavorQuotas,
    LocalQueue,
    ResourceFlavor,
    ResourceGroup,
    ResourceQuota,
    StopPolicy,
)
from kueue_tpu_torch.webhooks.validators import (
    validate_cluster_queue,
    validate_resource_flavor,
)

VERSION = "kueue-tpu v0.1 (round 1)"


class Kueuectl:
    def __init__(self, engine):
        self.engine = engine

    def _journal_delete(self, kind: str, key: str) -> None:
        if self.engine.journal is not None:
            self.engine.journal.delete(kind, key, ts=self.engine.clock)

    def _journal_apply(self, kind: str, obj) -> None:
        if self.engine.journal is not None:
            self.engine.journal.apply(kind, obj, ts=self.engine.clock)

    # -- create --

    def create_cluster_queue(self, name: str, cohort: Optional[str] = None,
                             nominal_quota: Optional[dict] = None,
                             borrowing_limit: Optional[dict] = None,
                             lending_limit: Optional[dict] = None,
                             queueing_strategy: str = "BestEffortFIFO"
                             ) -> ClusterQueue:
        """kueuectl create cq."""
        nominal_quota = nominal_quota or {}
        flavors: dict[str, dict[str, ResourceQuota]] = {}
        for key, val in nominal_quota.items():
            flavor, res = key.split(":", 1)
            flavors.setdefault(flavor, {})[res] = ResourceQuota(
                nominal=val,
                borrowing_limit=(borrowing_limit or {}).get(key),
                lending_limit=(lending_limit or {}).get(key))
        covered = tuple(sorted({res for f in flavors.values()
                                for res in f}))
        # Pad every flavor to cover all resources of the group.
        for f in flavors.values():
            for res in covered:
                f.setdefault(res, ResourceQuota(0))
        cq = ClusterQueue(
            name=name, cohort=cohort,
            resource_groups=(ResourceGroup(
                covered,
                tuple(FlavorQuotas(fn, fr)
                      for fn, fr in flavors.items())),) if flavors else (),
        )
        errs = validate_cluster_queue(cq) if flavors else []
        if errs:
            raise ValueError("; ".join(errs))
        self.engine.create_cluster_queue(cq)
        return cq

    def create_local_queue(self, name: str, cluster_queue: str,
                           namespace: str = "default") -> LocalQueue:
        lq = LocalQueue(name, namespace, cluster_queue)
        self.engine.create_local_queue(lq)
        return lq

    def create_resource_flavor(self, name: str,
                               node_labels: Optional[dict] = None
                               ) -> ResourceFlavor:
        rf = ResourceFlavor(name, node_labels=node_labels or {})
        errs = validate_resource_flavor(rf)
        if errs:
            raise ValueError("; ".join(errs))
        self.engine.create_resource_flavor(rf)
        return rf

    # -- list --

    def list_cluster_queues(self) -> list[dict]:
        out = []
        for name, cq in sorted(self.engine.cache.cluster_queues.items()):
            pcq = self.engine.queues.cluster_queues.get(name)
            out.append({
                "name": name,
                "cohort": cq.cohort or "",
                "pending": pcq.pending() if pcq else 0,
                "admitted": self.engine.cache.admitted_count(name),
                "active": cq.stop_policy == StopPolicy.NONE,
            })
        return out

    def list_local_queues(self, namespace: Optional[str] = None
                          ) -> list[dict]:
        out = []
        for key, lq in sorted(self.engine.queues.local_queues.items()):
            if namespace and lq.namespace != namespace:
                continue
            out.append({"name": lq.name, "namespace": lq.namespace,
                        "clusterQueue": lq.cluster_queue})
        return out

    def list_workloads(self, namespace: Optional[str] = None) -> list[dict]:
        out = []
        for key, wl in sorted(self.engine.workloads.items()):
            if namespace and wl.namespace != namespace:
                continue
            status = "Pending"
            if wl.is_finished:
                status = "Finished"
            elif wl.is_admitted:
                status = "Admitted"
            elif wl.has_quota_reservation:
                status = "QuotaReserved"
            elif wl.is_evicted:
                status = "Evicted"
            out.append({
                "name": wl.name, "namespace": wl.namespace,
                "queue": wl.queue_name, "priority": wl.effective_priority,
                "status": status, "active": wl.active,
            })
        return out

    def list_resource_flavors(self) -> list[dict]:
        return [{"name": rf.name, "nodeLabels": dict(rf.node_labels)}
                for rf in sorted(
                    self.engine.cache.resource_flavors.values(),
                    key=lambda r: r.name)]

    # -- stop / resume --

    def stop_workload(self, key: str) -> None:
        wl = self.engine.workloads.get(key)
        if wl is None:
            raise KeyError(key)
        wl.active = False
        if wl.has_quota_reservation:
            self.engine.evict(wl, "WorkloadStopped", requeue=False)
        self.engine.queues.delete_workload(wl)

    def resume_workload(self, key: str) -> None:
        wl = self.engine.workloads.get(key)
        if wl is None:
            raise KeyError(key)
        wl.active = True
        self.engine.queues.add_or_update_workload(wl)

    def stop_cluster_queue(self, name: str,
                           drain: bool = False) -> None:
        cq = self.engine.cache.cluster_queues.get(name)
        if cq is None:
            raise KeyError(name)
        cq.stop_policy = (StopPolicy.HOLD_AND_DRAIN if drain
                          else StopPolicy.HOLD)
        if drain:
            for key, info in list(self.engine.cache.workloads.items()):
                if info.cluster_queue == name:
                    wl = self.engine.workloads.get(key)
                    if wl is not None:
                        self.engine.evict(wl, "ClusterQueueStopped")
        self._journal_apply("cluster_queue", cq)

    def resume_cluster_queue(self, name: str) -> None:
        cq = self.engine.cache.cluster_queues.get(name)
        if cq is None:
            raise KeyError(name)
        cq.stop_policy = StopPolicy.NONE
        self.engine.queues.queue_inadmissible_workloads({name})
        self._journal_apply("cluster_queue", cq)

    def stop_local_queue(self, key: str, drain: bool = False) -> None:
        """kueuectl stop localqueue (stop/stop_localqueue.go). The held
        stop policy keeps the LQ's workloads out of the pending heaps
        (queues.add_or_update_workload gate)."""
        lq = self.engine.queues.local_queues.get(key)
        if lq is None:
            raise KeyError(key)
        lq.stop_policy = (StopPolicy.HOLD_AND_DRAIN if drain
                          else StopPolicy.HOLD)
        for wkey, wl in list(self.engine.workloads.items()):
            if f"{wl.namespace}/{wl.queue_name}" != key or wl.is_finished:
                continue
            if drain and wl.has_quota_reservation:
                self.engine.evict(wl, "LocalQueueStopped")
            elif not wl.has_quota_reservation:
                # Hold: pending workloads leave the queue until resume.
                self.engine.queues.delete_workload(wl)
        self._journal_apply("local_queue", lq)

    def resume_local_queue(self, key: str) -> None:
        lq = self.engine.queues.local_queues.get(key)
        if lq is None:
            raise KeyError(key)
        lq.stop_policy = StopPolicy.NONE
        # Re-queue the LQ's parked pending workloads (they were gated or
        # removed while stopped).
        for wl in self.engine.workloads.values():
            if f"{wl.namespace}/{wl.queue_name}" == key and wl.active \
                    and not wl.is_finished \
                    and not wl.has_quota_reservation:
                self.engine.queues.add_or_update_workload(wl)
        self.engine.queues.queue_inadmissible_workloads()
        self._journal_apply("local_queue", lq)

    # -- pods (list/list_pods.go: pods of a queued job) --

    def list_pods(self, workload_key: Optional[str] = None,
                  namespace: Optional[str] = None) -> list[dict]:
        """Pod-level rows derived from admissions: one row per admitted
        pod (pod set x count) with its flavor-derived node selector."""
        rows = []
        flavors = self.engine.cache.resource_flavors
        for key, wl in sorted(self.engine.workloads.items()):
            if workload_key and key != workload_key:
                continue
            if namespace and wl.namespace != namespace:
                continue
            if wl.status.admission is None:
                continue
            for psa in wl.status.admission.pod_set_assignments:
                selector = {}
                for fname in psa.flavors.values():
                    rf = flavors.get(fname)
                    if rf is not None:
                        selector.update(rf.node_labels)
                for i in range(psa.count):
                    rows.append({
                        "name": f"{wl.name}-{psa.name}-{i}",
                        "namespace": wl.namespace,
                        "workload": key,
                        "podSet": psa.name,
                        "nodeSelector": selector,
                        "phase": ("Running" if wl.is_admitted
                                  else "Pending"),
                    })
        return rows

    # -- describe (passthrough describe analog) --

    def describe_workload(self, key: str) -> dict:
        wl = self.engine.workloads.get(key)
        if wl is None:
            raise KeyError(key)
        from kueue_tpu_torch.workload_info import WorkloadInfo

        info = WorkloadInfo.from_workload(
            wl, wl.status.admission.cluster_queue
            if wl.status.admission else "",
            options=self.engine.info_options)
        return {
            "name": wl.name, "namespace": wl.namespace,
            "queue": wl.queue_name, "priority": wl.effective_priority,
            "active": wl.active,
            "conditions": [
                {"type": c.type, "status": c.status, "reason": c.reason,
                 "message": c.message}
                for c in wl.status.conditions.values()],
            "admission": None if wl.status.admission is None else {
                "clusterQueue": wl.status.admission.cluster_queue,
                "podSetAssignments": [
                    {"name": psa.name, "count": psa.count,
                     "flavors": dict(psa.flavors)}
                    for psa in wl.status.admission.pod_set_assignments],
            },
            "requeueCount": wl.status.requeue_count,
            "usage": {f"{fr.flavor}/{fr.resource}": q
                      for fr, q in info.usage().items()},
            "admissionChecks": dict(wl.status.admission_check_states),
        }

    def describe_cluster_queue(self, name: str) -> dict:
        from kueue_tpu_torch.controllers.status import StatusController

        cq = self.engine.cache.cluster_queues.get(name)
        if cq is None:
            raise KeyError(name)
        sc = self.engine.status_controller or StatusController(
            self.engine, attach=False)
        st = sc.cq_status(name)
        return {
            "name": name, "cohort": cq.cohort or "",
            "queueingStrategy": cq.queueing_strategy.value,
            "flavors": [
                {"name": fq.name,
                 "quotas": {res: {"nominal": q.nominal,
                                  "borrowingLimit": q.borrowing_limit,
                                  "lendingLimit": q.lending_limit}
                            for res, q in fq.resources.items()}}
                for rg in cq.resource_groups for fq in rg.flavors],
            "status": vars(st) if st is not None else None,
        }

    def describe_local_queue(self, key: str) -> dict:
        from kueue_tpu_torch.controllers.status import StatusController

        lq = self.engine.queues.local_queues.get(key)
        if lq is None:
            raise KeyError(key)
        sc = self.engine.status_controller or StatusController(
            self.engine, attach=False)
        st = sc.lq_status(key)
        return {"name": lq.name, "namespace": lq.namespace,
                "clusterQueue": lq.cluster_queue,
                "status": vars(st) if st is not None else None}

    # -- delete --

    def delete_workload(self, key: str) -> None:
        """delete/delete_workload.go: the workload leaves the engine,
        the cache and its queue; the journal records the delete (the HA
        replica's ``revoke`` deletes through it)."""
        wl = self.engine.workloads.pop(key, None)
        if wl is not None:
            self.engine.cache.delete_workload(key)
            self.engine.queues.delete_workload(wl)
            self._journal_delete("workload", key)

    def delete_cluster_queue(self, name: str) -> None:
        """delete/delete_clusterqueue.go: the queue (and its pending
        heap) go away; workload objects stay registered, unqueued."""
        self.engine.cache.cluster_queues.pop(name, None)
        self.engine.queues.cluster_queues.pop(name, None)
        self._journal_delete("cluster_queue", name)

    def delete_local_queue(self, key: str) -> None:
        self.engine.queues.delete_local_queue(key)
        self._journal_delete("local_queue", key)

    def delete_resource_flavor(self, name: str) -> None:
        self.engine.cache.resource_flavors.pop(name, None)
        self._journal_delete("resource_flavor", name)

    # -- passthrough (app/passthrough: get on any kueue kind) --

    def get(self, kind: str, name: Optional[str] = None,
            namespace: Optional[str] = None):
        table = {
            "clusterqueues": self.list_cluster_queues,
            "localqueues": lambda: self.list_local_queues(namespace),
            "workloads": lambda: self.list_workloads(namespace),
            "resourceflavors": self.list_resource_flavors,
            "pods": lambda: self.list_pods(namespace=namespace),
        }
        if kind not in table:
            raise KeyError(f"unknown kind {kind}")
        rows = table[kind]()
        if name is not None:
            rows = [r for r in rows if r.get("name") == name]
        return rows

    # -- explain (obs/: why is my workload pending?) --

    def explain(self, key: str, probe: bool = True) -> dict:
        from kueue_tpu_torch.obs import explain_workload
        return explain_workload(self.engine, key, probe=probe)

    def version(self) -> str:
        return VERSION


def _endpoint_url(endpoint: str, path: str) -> str:
    """Accept both host:port and full http://host:port endpoints."""
    base = endpoint.rstrip("/")
    if "://" not in base:
        base = "http://" + base
    return base + path


def _parse_quota_pairs(pairs: list[str]) -> dict:
    """--nominal-quota flavor:resource=value [...]"""
    out = {}
    for pair in pairs or []:
        key, val = pair.split("=", 1)
        out[key] = int(val)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kueuectl")
    sub = p.add_subparsers(dest="command")
    sub.add_parser("version")

    lst = sub.add_parser("list")
    lst.add_argument("kind", choices=["clusterqueues", "localqueues",
                                      "workloads", "resourceflavors",
                                      "pods"])
    lst.add_argument("--namespace")
    lst.add_argument("--for", dest="for_workload",
                     help="workload key for pods listing")

    get = sub.add_parser("get")  # passthrough
    get.add_argument("kind")
    get.add_argument("name", nargs="?")
    get.add_argument("--namespace")

    desc = sub.add_parser("describe")
    desc.add_argument("kind", choices=["workload", "clusterqueue",
                                       "localqueue"])
    desc.add_argument("name")
    desc.add_argument("--namespace", default="default")

    create = sub.add_parser("create")
    create.add_argument("kind", choices=["clusterqueue", "localqueue",
                                         "resourceflavor"])
    create.add_argument("name")
    create.add_argument("--cohort")
    create.add_argument("--clusterqueue")
    create.add_argument("--namespace", default="default")
    create.add_argument("--nominal-quota", nargs="*", default=[],
                        help="flavor:resource=value pairs")
    create.add_argument("--queueing-strategy", default="BestEffortFIFO")
    create.add_argument("--node-label", nargs="*", default=[],
                        help="key=value pairs")
    create.add_argument("--dry-run", choices=["none", "client"],
                        default="none")

    for verb in ("stop", "resume"):
        cmd = sub.add_parser(verb)
        cmd.add_argument("kind", choices=["workload", "clusterqueue",
                                          "localqueue"])
        cmd.add_argument("name")
        cmd.add_argument("--namespace", default="default")
        if verb == "stop":
            cmd.add_argument("--drain", action="store_true")

    dele = sub.add_parser("delete")
    dele.add_argument("kind", choices=["workload", "clusterqueue",
                                       "localqueue", "resourceflavor"])
    dele.add_argument("name")
    dele.add_argument("--namespace", default="default")
    dele.add_argument("--dry-run", choices=["none", "client"],
                      default="none")

    rec = sub.add_parser(
        "record",
        help="flight-record the engine: bootstrap the current "
             "(journal-rebuilt) world into a trace, then run scheduling "
             "cycles until quiescent (or --cycles)")
    rec.add_argument("out", help="trace path to write")
    rec.add_argument("--cycles", type=int, default=0,
                     help="cycle budget (0 = run until quiescent)")
    rec.add_argument("--label", default="")

    rep = sub.add_parser(
        "replay",
        help="deterministically re-execute a flight-recorder trace and "
             "verify the decision stream (exit non-zero on divergence)")
    rep.add_argument("trace")
    rep.add_argument("--mode", choices=["host", "device", "both"],
                     default="host",
                     help="host = sequential core; device = oracle "
                          "attached; both = differential host-vs-device")
    rep.add_argument("--faults",
                     help="fault spec armed on the replay engine, e.g. "
                          "oracle-crash@cycle:2 (see replay/faults.py)")
    rep.add_argument("--stop-after", type=int, dest="stop_after",
                     help="replay only the first N cycles")

    exp = sub.add_parser(
        "explain",
        help="why is my workload pending: last traced decision "
             "(per-flavor rejection reasons, preemption rationale, "
             "correlation id) plus a live what-if probe")
    exp.add_argument("name")
    exp.add_argument("--namespace", default="default")
    exp.add_argument("--json", action="store_true", dest="as_json",
                     help="emit the structured report instead of text")
    exp.add_argument("--no-probe", action="store_true",
                     help="skip the live one-shot nomination probe")

    slo = sub.add_parser(
        "slo",
        help="serving objectives: declared targets, multi-window burn "
             "rates and ok/warn/breach status (obs/slo.py)")
    slo.add_argument("--json", action="store_true", dest="as_json",
                     help="emit the structured summary instead of text")

    st = sub.add_parser(
        "status",
        help="HA replica status: role, lease epoch, journal replay "
             "lag, connected SSE clients (kueue_tpu_torch/ha). Query a live "
             "replica with --endpoint, or inspect the lease/journal "
             "offline with --journal/--lease")
    st.add_argument("--endpoint",
                    help="base URL of a live replica "
                         "(e.g. http://127.0.0.1:8080): queries "
                         "/debug/ha")
    st.add_argument("--lease",
                    help="lease file for offline inspection "
                         "(default: <journal>.lease)")
    st.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the raw status dict")

    cl = sub.add_parser(
        "cells",
        help="federation cell status: per-cell health, breaker state, "
             "fence epoch and route-state counts (kueue_tpu_torch/federation)."
             " Query a live dispatcher with --endpoint, or fold a "
             "dispatcher route journal offline with --journal")
    cl.add_argument("--endpoint",
                    help="base URL of a live federation dispatcher "
                         "(e.g. http://127.0.0.1:8080): queries /cells")
    cl.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the raw status dict")

    tr = sub.add_parser(
        "trace", help="span-tree operations (obs/)")
    trs = tr.add_subparsers(dest="trace_command")
    texp = trs.add_parser(
        "export",
        help="export span trees as Chrome/Perfetto trace-event JSON "
             "(open in ui.perfetto.dev or chrome://tracing)")
    texp.add_argument("--out", required=True, help="output JSON path")
    texp.add_argument("--input",
                      help="flight-recorder trace (.jsonl) to convert "
                           "offline; default: the live engine's "
                           "retained spans")
    texp.add_argument("--last", type=int, default=0,
                      help="export only the newest N cycle span trees")
    return p


def main(argv=None) -> None:
    """Console entry point: operate on a journal-backed engine
    (--journal points at the durable store; commands replay it, apply,
    and mutations are journaled back). ``--device cuda|cpu`` (CUDA by
    default) is the device of the engine built here and of the engines
    ``replay`` builds."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            raise SystemExit("--device requires cuda or cpu")
        device = argv[i + 1]
        del argv[i:i + 2]
    from kueue_tpu_torch.device import resolve_device

    resolve_device(device)  # CUDA unless asked for the CPU, as serve
    journal = None
    if "--journal" in argv:
        i = argv.index("--journal")
        if i + 1 >= len(argv):
            raise SystemExit("--journal requires a path argument")
        journal = argv[i + 1]
        del argv[i:i + 2]
    if journal:
        from kueue_tpu_torch.store.journal import rebuild_engine

        engine = rebuild_engine(journal, device=device)
    else:
        from kueue_tpu_torch.controllers.engine import Engine

        engine = Engine(device=device)
    print(run(engine, argv))


def run(engine, argv: list[str]) -> str:
    """Entry point: returns rendered output."""
    ctl = Kueuectl(engine)
    args = build_parser().parse_args(argv)
    if args.command == "version":
        return ctl.version()
    if args.command == "list":
        fn = {
            "clusterqueues": ctl.list_cluster_queues,
            "localqueues": lambda: ctl.list_local_queues(args.namespace),
            "workloads": lambda: ctl.list_workloads(args.namespace),
            "resourceflavors": ctl.list_resource_flavors,
            "pods": lambda: ctl.list_pods(args.for_workload,
                                          args.namespace),
        }[args.kind]
        return json.dumps(fn(), indent=2)
    if args.command == "get":
        return json.dumps(ctl.get(args.kind, args.name, args.namespace),
                          indent=2)
    if args.command == "describe":
        key = f"{args.namespace}/{args.name}"
        fn = {
            "workload": lambda: ctl.describe_workload(key),
            "clusterqueue": lambda: ctl.describe_cluster_queue(args.name),
            "localqueue": lambda: ctl.describe_local_queue(key),
        }[args.kind]
        return json.dumps(fn(), indent=2)
    if args.command == "create":
        if args.dry_run != "none":
            return f"{args.kind}/{args.name} created (dry run)"
        if args.kind == "clusterqueue":
            ctl.create_cluster_queue(
                args.name, cohort=args.cohort,
                nominal_quota=_parse_quota_pairs(args.nominal_quota),
                queueing_strategy=args.queueing_strategy)
        elif args.kind == "localqueue":
            if not args.clusterqueue:
                raise SystemExit("--clusterqueue is required")
            ctl.create_local_queue(args.name, args.clusterqueue,
                                   namespace=args.namespace)
        else:
            labels = dict(pair.split("=", 1)
                          for pair in args.node_label)
            ctl.create_resource_flavor(args.name, node_labels=labels)
        return f"{args.kind}/{args.name} created"
    if args.command in ("stop", "resume"):
        key = f"{args.namespace}/{args.name}"
        table = {
            ("stop", "workload"): lambda: ctl.stop_workload(key),
            ("stop", "clusterqueue"): lambda: ctl.stop_cluster_queue(
                args.name, drain=args.drain),
            ("stop", "localqueue"): lambda: ctl.stop_local_queue(
                key, drain=args.drain),
            ("resume", "workload"): lambda: ctl.resume_workload(key),
            ("resume", "clusterqueue"): lambda: ctl.resume_cluster_queue(
                args.name),
            ("resume", "localqueue"): lambda: ctl.resume_local_queue(key),
        }
        table[(args.command, args.kind)]()
        return f"{args.kind}/{args.name} {args.command}ped" \
            if args.command == "stop" else f"{args.kind}/{args.name} resumed"
    if args.command == "record":
        from kueue_tpu_torch.replay.recorder import FlightRecorder
        recorder = FlightRecorder(engine, args.out, bootstrap=True,
                                  label=args.label)
        ran = 0
        try:
            while True:
                result = engine.schedule_once()
                ran += 1
                if args.cycles and ran >= args.cycles:
                    break
                if not args.cycles and result is None:
                    break
        finally:
            recorder.close()
        return (f"recorded {ran} cycle(s) -> {args.out} "
                f"(digest {recorder.digest})")
    if args.command == "replay":
        from kueue_tpu_torch.replay.replayer import replay_trace
        report = replay_trace(args.trace, mode=args.mode,
                              faults=args.faults,
                              stop_after_cycles=args.stop_after,
                              device=engine.device)
        if not report.ok:
            raise SystemExit(report.render())
        return report.render()
    if args.command == "explain":
        from kueue_tpu_torch.obs import explain_workload, render_explain
        report = explain_workload(engine, f"{args.namespace}/{args.name}",
                                  probe=not args.no_probe)
        if args.as_json:
            return json.dumps(report, indent=2, default=str)
        return render_explain(report)
    if args.command == "slo":
        slo = getattr(engine, "slo", None)
        if slo is None:
            # Declarative objectives exist without an engine loop — show
            # the declared targets with empty windows rather than
            # refusing (a journal-rebuilt engine has no live history).
            from kueue_tpu_torch.obs.slo import attach_slo
            slo = attach_slo(engine)
        summary = slo.summary()
        if args.as_json:
            return json.dumps(summary, indent=2)
        lines = [f"cycles observed: {summary['cyclesObserved']}",
                 "windows: " + ", ".join(
                     f"{w}={n} cycles"
                     for w, n in summary["windows"].items())]
        header = (f"{'OBJECTIVE':<24} {'KIND':<16} {'TARGET':>10} "
                  f"{'BURN(fast)':>11} {'BURN(slow)':>11} STATUS")
        lines.append(header)
        for name, ev in summary["objectives"].items():
            burns = ev["burn"]
            lines.append(
                f"{name:<24} {ev['kind']:<16} {ev['target']:>10.3g} "
                f"{burns.get('fast', 0.0):>11.3f} "
                f"{burns.get('slow', 0.0):>11.3f} {ev['statusName']}")
        return "\n".join(lines)
    if args.command == "status":
        if args.endpoint:
            # Live replica: /debug/ha is the authoritative view.
            import urllib.request
            url = _endpoint_url(args.endpoint, "/debug/ha")
            with urllib.request.urlopen(url, timeout=5) as resp:
                status = json.loads(resp.read())
            # Read replicas answer /debug/readplane with their
            # staleness envelope; HA replicas/leaders answer
            # {"enabled": false}. Either way the fetch is additive —
            # a pre-readplane server 404s and we show nothing.
            try:
                rp_url = _endpoint_url(args.endpoint, "/debug/readplane")
                with urllib.request.urlopen(rp_url, timeout=5) as resp:
                    rp = json.loads(resp.read())
                if rp.get("enabled"):
                    status["readplane"] = rp
            except (OSError, ValueError):
                pass
        elif getattr(engine, "ha", None) is not None:
            status = engine.ha.status()
        else:
            # Offline: read the lease file and the journal's last HA
            # checkpoint directly (no replica process required).
            status = {"role": "offline", "identity": ""}
            journal = getattr(engine, "journal", None)
            lease_path = args.lease or (
                journal.path + ".lease" if journal is not None else None)
            if lease_path:
                from kueue_tpu_torch.ha.lease import FencedLease
                lease = FencedLease(lease_path).read()
                status["leaseHolder"] = lease.holder if lease else ""
                status["epoch"] = lease.epoch if lease else 0
            if journal is not None:
                from kueue_tpu_torch.ha.digest import last_checkpoint
                records = list(journal.replay())
                _, ckpt = last_checkpoint(records)
                status["journalRecords"] = len(records)
                status["lastCheckpoint"] = (ckpt["obj"] if ckpt
                                            else None)
        if args.as_json:
            return json.dumps(status, indent=2)
        lines = [f"role: {status.get('role', 'unknown')}"]
        if status.get("identity"):
            lines.append(f"identity: {status['identity']}")
        lines.append(
            f"lease: holder={status.get('leaseHolder', '')!r} "
            f"epoch={status.get('epoch', 0)}")
        if "replayLag" in status:
            lines.append(f"replay lag: {status['replayLag']} record(s)")
        if "journalRecords" in status:
            lines.append(
                f"journal: {status['journalRecords']} record(s)")
        ckpt = status.get("lastCheckpoint") or (
            status.get("tailer") or {}).get("lastCheckpoint")
        if ckpt:
            lines.append(
                f"checkpoint: seq={ckpt.get('seq')} "
                f"epoch={ckpt.get('epoch')} chain={ckpt.get('chain')} "
                f"state={ckpt.get('state')}")
        if "sseClients" in status:
            sse = status.get("sse", {})
            lines.append(
                f"sse clients: {status['sseClients']} connected "
                f"({sse.get('dropped', 0)} dropped, "
                f"{sse.get('evicted', 0)} evicted)")
        if "decisionDigest" in status:
            lines.append(
                f"decision digest: {status['decisionDigest']} "
                f"@ seq {status.get('digestSeq')}")
        if status.get("shedder"):
            sh = status["shedder"]
            lines.append(
                f"shedder: accepted={sh['accepted']} shed={sh['shed']} "
                f"factor={sh['factor']}")
        rp = status.get("readplane")
        if rp:
            lines.append(f"read replica: {rp.get('replica', '?')} "
                         f"(journal={rp.get('journal', '?')}, "
                         f"queries={rp.get('queries', 0)})")
            st = rp.get("staleness")
            if st:
                pos = st.get("position") or {}
                lines.append(
                    f"  rebuilt @ lineage {pos.get('lineage', '?')} "
                    f"seg {pos.get('segment', '?')} "
                    f"offset {pos.get('offset', '?')} "
                    f"cid={st.get('cid') or '-'}")
                age = st.get("wallAgeSeconds")
                lines.append(
                    f"  staleness: lag={st.get('lagRecords', '?')} "
                    f"record(s), age="
                    + (f"{age:.3f}s" if age is not None else "?"))
            else:
                lines.append("  staleness: no rebuild yet")
            slo = rp.get("readSlo") or {}
            worst = None
            for name, ev in (slo.get("objectives") or {}).items():
                if worst is None or ev["status"] > worst[1]["status"]:
                    worst = (name, ev)
            if worst is not None:
                lines.append(
                    f"  read SLO worst: {worst[0]} "
                    f"{worst[1]['statusName']}")
        return "\n".join(lines)
    if args.command == "cells":
        if args.endpoint:
            # Live dispatcher: /cells is the authoritative view.
            import urllib.request
            url = _endpoint_url(args.endpoint, "/cells")
            with urllib.request.urlopen(url, timeout=5) as resp:
                status = json.loads(resp.read())
        else:
            # Offline: fold the dispatcher's route journal directly.
            # fed_route/fed_cell are EPHEMERAL_KINDS, so the engine
            # rebuild skipped them — replay the raw record stream.
            journal = getattr(engine, "journal", None)
            if journal is None:
                raise SystemExit(
                    "kueuectl cells needs --endpoint or --journal "
                    "pointed at a dispatcher route journal")
            routes: dict = {}
            epochs: dict = {}
            for rec in journal.replay():
                obj = rec.get("obj", {})
                if rec["kind"] == "fed_route":
                    if rec["op"] == "delete":
                        routes.pop(rec["key"], None)
                    else:
                        routes[obj["name"]] = obj
                elif rec["kind"] == "fed_cell" and rec["op"] != "delete":
                    epochs[obj["name"]] = obj
            per_cell: dict = {}
            route_counts: dict = {}
            for r in routes.values():
                d = per_cell.setdefault(r["cell"], {})
                d[r["state"]] = d.get(r["state"], 0) + 1
                route_counts[r["state"]] = (
                    route_counts.get(r["state"], 0) + 1)
            status = {
                "offline": True, "routes": route_counts,
                "cells": [dict(name=n, epoch=st.get("epoch", 1),
                               up=st.get("up"),
                               routes=per_cell.get(n, {}))
                          for n, st in sorted(epochs.items())]}
            for name in sorted(set(per_cell) - set(epochs)):
                status["cells"].append(
                    dict(name=name, epoch=1, up=None,
                         routes=per_cell[name]))
        if args.as_json:
            return json.dumps(status, indent=2)
        lines = []
        rc = status.get("routes", {})
        lines.append(
            "routes: " + (", ".join(
                f"{s}={rc[s]}" for s in sorted(rc)) or "none"))
        if "handoffs" in status:
            lines.append(
                f"handoffs: {status['handoffs']} "
                f"redispatches: {status.get('redispatches', 0)} "
                f"revocations: {status.get('revocations', 0)}")
        header = (f"{'CELL':<16} {'UP':<6} {'EPOCH':>6} "
                  f"{'BREAKER':<10} ROUTES")
        lines.append(header)
        for c in status.get("cells", []):
            up = {True: "yes", False: "no"}.get(c.get("up"), "?")
            breaker = (c.get("breaker") or {}).get("state", "-")
            rts = ", ".join(f"{s}={n}" for s, n in
                            sorted((c.get("routes") or {}).items()))
            lines.append(f"{c['name']:<16} {up:<6} "
                         f"{c.get('epoch', 1):>6} {breaker:<10} "
                         f"{rts or '-'}")
        return "\n".join(lines)
    if args.command == "trace":
        if args.trace_command != "export":
            raise SystemExit("usage: kueuectl trace export --out FILE")
        from kueue_tpu_torch.obs import spans_from_flight_trace, write_perfetto
        if args.input:
            roots = spans_from_flight_trace(args.input)
        else:
            tracer = getattr(engine, "tracer", None)
            if tracer is None:
                raise SystemExit(
                    "no tracer attached to this engine and no --input "
                    "flight trace given (serve with --trace, or pass "
                    "--input RECORDING.jsonl)")
            roots = list(tracer.spans)
        if args.last:
            roots = roots[-args.last:]
        n = write_perfetto(roots, args.out)
        return (f"exported {n} trace event(s) from {len(roots)} "
                f"cycle span tree(s) -> {args.out}")
    if args.command == "delete":
        if args.dry_run != "none":
            return f"{args.kind}/{args.name} deleted (dry run)"
        key = f"{args.namespace}/{args.name}"
        {
            "workload": lambda: ctl.delete_workload(key),
            "clusterqueue": lambda: ctl.delete_cluster_queue(args.name),
            "localqueue": lambda: ctl.delete_local_queue(key),
            "resourceflavor": lambda: ctl.delete_resource_flavor(
                args.name),
        }[args.kind]()
        return f"{args.kind}/{args.name} deleted"
    return ""


if __name__ == "__main__":
    main()
