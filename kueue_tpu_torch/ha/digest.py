"""Failover digest verification: prove the journal reproduces the
leader's decisions before a follower accepts writes.

The port of ``kueue_tpu/ha/digest.py``. Two digests, both deterministic
functions of journal content:

  * **decision chain** — the flight recorder's CRC chain
    (replay/trace.py ``decision_digest``) over every non-idle cycle's
    canonical decision record. The leader carries it across cycles; a
    promoting follower seeds its own chain from the last checkpoint so
    the stream digest spans leadership terms.
  * **admitted-state digest** — an order-canonical CRC over the
    engine's current applied admissions (key + full Admission object),
    the same for a live leader and a journal rebuild of the same state:
    replay to head must land on the state the dead leader checkpointed.
    A sealed checkpoint's header carries it too (store/checkpoint.py).

The leader journals one ``ha_digest`` record per non-idle cycle from a
pre-sync hook (``Engine.pre_sync_hooks``): the record rides inside the
cycle's fsync boundary. Rebuilds skip ``ha_digest`` records
(``store.journal.EPHEMERAL_KINDS``). A SIGKILL mid-apply can leave
workload records after the last checkpoint (a partially applied
cycle's durable admissions): verification then proves the checkpointed
prefix and adopts the tail. The records are the JAX package's, byte
for byte, so either package promotes the other's journal.
"""

from __future__ import annotations

import json
import zlib
from typing import Optional

HEAD_KEY = "head"  # single logical journal key for ha_digest records


def _canon_crc(obj) -> int:
    return zlib.crc32(json.dumps(obj, sort_keys=True,
                                 separators=(",", ":")).encode("utf-8"))


def admitted_state_digest(engine) -> str:
    """Order-canonical digest of the engine's applied admissions:
    sorted (key, Admission) pairs, serde-canonical JSON, CRC-32.
    Identical for a live leader and a journal rebuild of the same
    state — the promotion verification invariant.

    The JSON is the JAX package's ``json.dumps`` of the rows, built as
    the rows' own encodings joined inside ``[...]``: an engine keeps
    each row's encoding with the Admission it encodes (a frozen
    dataclass, replaced on change, never changed in place), so the
    digest a leader writes every cycle re-encodes only the admissions
    that changed (at 50,000 admitted workloads a full encode takes most
    of a second)."""
    from kueue_tpu_torch.api.serde import to_jsonable

    memo = engine.__dict__.setdefault("_admission_rows", {})
    parts = []
    for key in sorted(engine.workloads):
        wl = engine.workloads[key]
        adm = wl.status.admission
        if adm is None or wl.is_finished:
            continue
        hit = memo.get(key)
        if hit is None or hit[0] is not adm:
            hit = memo[key] = (adm, json.dumps(
                [key, to_jsonable(adm)], sort_keys=True,
                separators=(",", ":")))
        parts.append(hit[1])
    if len(memo) > 2 * len(parts) + 1024:
        live = set(engine.workloads)
        for key in [k for k in memo if k not in live]:
            del memo[key]
    return f"{zlib.crc32(('[' + ','.join(parts) + ']').encode()):08x}"


class DigestChain:
    """Leader-side checkpoint writer. Registered on
    ``engine.pre_sync_hooks`` so each non-idle cycle's checkpoint is
    appended AFTER the cycle's workload records and BEFORE the
    crash-safe fsync: one atomic durability unit per cycle."""

    def __init__(self, engine, epoch: int, seed_chain: int = 0,
                 seed_seq: int = -1):
        self.engine = engine
        self.epoch = epoch
        self.chain = seed_chain
        self.last_seq = seed_seq
        self.cycles = 0
        self._hook = self._on_pre_sync
        engine.pre_sync_hooks.append(self._hook)

    def _on_pre_sync(self, seq: int, result) -> None:
        from kueue_tpu_torch.obs.span import correlation_id
        from kueue_tpu_torch.replay.trace import canonical_decisions, \
            decision_digest

        decisions = canonical_decisions(result)
        self.chain = decision_digest(decisions, self.chain)
        self.last_seq = seq
        self.cycles += 1
        self.engine.journal.apply("ha_digest", {
            "name": HEAD_KEY,
            "seq": seq,
            "epoch": self.epoch,
            "chain": f"{self.chain:08x}",
            "state": admitted_state_digest(self.engine),
            "cid": correlation_id(seq, decisions),
        }, ts=self.engine.clock)

    @property
    def digest(self) -> str:
        return f"{self.chain:08x}"

    def detach(self) -> None:
        try:
            self.engine.pre_sync_hooks.remove(self._hook)
        except ValueError:
            pass


def last_checkpoint(records) -> tuple:
    """(index, record-or-None) of the final ha_digest record."""
    idx, found = -1, None
    for i, rec in enumerate(records):
        if rec.get("kind") == "ha_digest" and rec.get("op") == "apply":
            idx, found = i, rec
    return idx, found


def verify_promotion(records, rebuilt_engine,
                     new_epoch: Optional[int] = None,
                     base_records: Optional[list] = None,
                     base_meta=None) -> dict:
    """The promotion gate: given the journal's records (replayed to
    head) and the engine rebuilt from them, prove digest identity
    against the dead leader's last checkpoint.

    Returns a report dict; ``verified`` False means the journal does
    NOT reproduce the checkpointed state — the candidate must fence,
    not lead. ``chain_seed``/``seq_seed`` carry the decision chain
    forward into the new term's DigestChain.

    Checkpoint+suffix boot (store/checkpoint.py): ``records`` is then
    only the journal SUFFIX, ``base_records`` the sealed checkpoint's
    payload and ``base_meta`` its header. A sealed checkpoint embeds
    the same chain/state digests an ``ha_digest`` record carries, so
    when the suffix holds no ha_digest of its own the verification
    anchors on the sealed header — same protocol, older anchor."""
    report = {
        "verified": True,
        "checkpoint_seq": None,
        "checkpoint_epoch": 0,
        "chain_seed": 0,
        "seq_seed": -1,
        "partial_cycle": False,
        "source": "journal",
        "rebuilt_state": admitted_state_digest(rebuilt_engine),
        "checkpoint_state": None,
        "reason": "no checkpoint (fresh journal)",
    }
    base_records = base_records or []
    idx, ckpt = last_checkpoint(records)
    if ckpt is None and base_meta is not None:
        # No ha_digest in the suffix: anchor on the sealed checkpoint.
        report.update({
            "source": "sealed-checkpoint",
            "checkpoint_seq": base_meta.seq,
            "checkpoint_epoch": int(base_meta.epoch),
            "chain_seed": int(base_meta.chain or "0", 16),
            "seq_seed": int(base_meta.chain_seq),
            "checkpoint_state": base_meta.state,
        })
        if new_epoch is not None and base_meta.epoch >= new_epoch:
            report["verified"] = False
            report["reason"] = (
                f"fencing violation: sealed checkpoint epoch "
                f"{base_meta.epoch} >= new epoch {new_epoch}")
            return report
        tail_writes = [r for r in records
                       if r.get("kind") == "workload"]
        if not tail_writes:
            ok = report["rebuilt_state"] == base_meta.state
            report["verified"] = ok
            report["reason"] = (
                "digest identity at sealed checkpoint" if ok else
                f"state digest mismatch: rebuilt "
                f"{report['rebuilt_state']} != sealed checkpoint "
                f"{base_meta.state}")
            return report
        from kueue_tpu_torch.store.journal import engine_from_records

        prefix_state = admitted_state_digest(
            engine_from_records(list(base_records)))
        ok = prefix_state == base_meta.state
        report["partial_cycle"] = True
        report["verified"] = ok
        report["reason"] = (
            f"sealed-checkpoint prefix digest identity + "
            f"{len(tail_writes)} adopted partial-cycle record(s)"
            if ok else
            f"sealed-checkpoint prefix state digest mismatch: "
            f"{prefix_state} != {base_meta.state}")
        return report
    if ckpt is None:
        return report
    obj = ckpt["obj"]
    report.update({
        "checkpoint_seq": obj.get("seq"),
        "checkpoint_epoch": int(obj.get("epoch", 0)),
        "chain_seed": int(obj.get("chain", "0"), 16),
        "seq_seed": int(obj.get("seq", -1)),
        "checkpoint_state": obj.get("state"),
    })
    if new_epoch is not None and report["checkpoint_epoch"] >= new_epoch:
        report["verified"] = False
        report["reason"] = (
            f"fencing violation: checkpoint epoch "
            f"{report['checkpoint_epoch']} >= new epoch {new_epoch}")
        return report
    tail_writes = [r for r in records[idx + 1:]
                   if r.get("kind") == "workload"]
    if not tail_writes:
        # Clean boundary (leader died between cycles): the rebuilt
        # state must BE the checkpointed state.
        ok = report["rebuilt_state"] == obj.get("state")
        report["verified"] = ok
        report["reason"] = ("digest identity at checkpoint" if ok else
                            f"state digest mismatch: rebuilt "
                            f"{report['rebuilt_state']} != checkpoint "
                            f"{obj.get('state')}")
        return report
    # Crash mid-cycle: workload records landed after the checkpoint.
    # Verify the checkpointed PREFIX reproduces byte-identically, then
    # adopt the tail (durable applied admissions — dropping them would
    # violate zero-loss).
    from kueue_tpu_torch.store.journal import engine_from_records

    prefix_engine = engine_from_records(base_records + records[:idx + 1])
    prefix_state = admitted_state_digest(prefix_engine)
    ok = prefix_state == obj.get("state")
    report["partial_cycle"] = True
    report["verified"] = ok
    report["reason"] = (
        f"prefix digest identity + {len(tail_writes)} adopted "
        f"partial-cycle record(s)" if ok else
        f"prefix state digest mismatch: {prefix_state} != "
        f"{obj.get('state')}")
    return report
