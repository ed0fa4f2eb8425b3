"""TAS balanced placement (feature gate ``TASBalancedPlacement``).

Reference: pkg/cache/scheduler/tas_balanced_placement.go (381 LoC) wired
in at tas_flavor_snapshot.go:1064-1080. Instead of best-fit packing,
spread the slices *evenly*: find the maximum threshold T such that every
selected domain can take at least T slices, select the optimal domain set
via dynamic programming (minimum domain count, then minimum leftover
capacity), and hand each selected domain T slices plus a fair share of
the remainder. Leaders are reserved on the first selected domain.

Used on preferred-mode requests only (never required/unconstrained); any
failure falls back to best-fit. Host-only: the device program returns
NotImplemented for such requests (tas/device.try_find).

A copy of ``kueue_tpu/tas/balanced.py``.
"""

from __future__ import annotations

import math
from typing import Optional

from kueue_tpu_torch.tas.snapshot import _Domain, clone_domains

_NEG_INF = -(1 << 60)


def evaluate_greedy(snapshot, domains: list[_Domain], slice_count: int,
                    leader_count: int):
    """evaluateGreedyAssignment: simulate best-fit placement; return
    (fits, domains_used, last_leader_domain, last_worker_domain)."""
    selected = 0
    last_with_leader = None
    last = None
    rem_slices = slice_count
    rem_leaders = leader_count
    idx = 0
    if leader_count > 0:
        with_leader = snapshot._sorted_with_leader(domains, False)
        while rem_leaders > 0 and idx < len(with_leader) \
                and with_leader[idx].leader_state > 0:
            selected += 1
            last_with_leader = with_leader[idx]
            rem_leaders -= with_leader[idx].leader_state
            rem_slices -= with_leader[idx].slice_state_with_leader
            idx += 1
        rest = snapshot._sorted(with_leader[idx:], False)
    else:
        rest = snapshot._sorted(domains, False)
    if rem_leaders > 0:
        return False, 0, None, None
    for d in rest:
        if rem_slices <= 0:
            break
        if d.slice_state <= 0:
            break
        selected += 1
        last = d
        rem_slices -= d.slice_state
    if rem_slices > 0:
        return False, 0, None, None
    return True, selected, last_with_leader, last


def threshold_value(slice_count: int, selected: int, last_with_leader,
                    last) -> int:
    """balanceThresholdValue: the max possible min-slices-per-domain."""
    threshold = slice_count // selected
    if last_with_leader is not None:
        threshold = min(threshold, last_with_leader.slice_state_with_leader)
    if last is not None:
        threshold = min(threshold, last.slice_state)
    return threshold


def _entropy(domains: list[_Domain]) -> float:
    """calculateDomainsEntropy over children states."""
    total = sum(d.state for d in domains)
    if total == 0:
        return 0.0
    entropy = 0.0
    for d in domains:
        if d.state > 0:
            p = d.state / total
            entropy += -p * math.log2(p)
    return entropy


def _entropy_key(d: _Domain):
    """compareDomainCapacityAndEntropy (descending leader/slice/entropy)."""
    return (-d.leader_state, -d.slice_state_with_leader,
            -_entropy(d.children), d.values)


def select_optimal_domain_set(snapshot, domains: list[_Domain],
                              slice_count: int, leader_count: int,
                              slice_size: int,
                              prioritize_by_entropy: bool
                              ) -> Optional[list[_Domain]]:
    """selectOptimalDomainSetToFit: DP over (#domains, leaders left, pods
    left) to find a fitting subset using the greedy-minimal number of
    domains with the least leftover capacity."""
    fits, optimal, _, _ = evaluate_greedy(snapshot, domains, slice_count,
                                          leader_count)
    if not fits:
        return None

    ordered = sorted(domains,
                     key=_entropy_key if prioritize_by_entropy
                     else lambda d: d.values)

    # dp[i][leaders_left][pods_left] -> chosen domain list (first wins)
    dp: list[dict[int, dict[int, list[_Domain]]]] = [
        {} for _ in range(optimal + 1)]
    dp[0][leader_count] = {slice_count * slice_size: []}

    for d in ordered:
        for i in range(optimal, 0, -1):
            for before_leader in sorted(dp[i - 1]):
                for before_state in sorted(dp[i - 1][before_leader]):
                    if before_leader <= 0 and before_state <= 0:
                        continue
                    placement = dp[i - 1][before_leader][before_state] + [d]
                    if before_leader > 0 and d.leader_state > 0:
                        after_leader = before_leader - d.leader_state
                        after_state = before_state - d.state_with_leader
                        bucket = dp[i].setdefault(after_leader, {})
                        bucket.setdefault(after_state, placement)
                    if d.slice_state > 0:
                        after_state = before_state - d.state
                        bucket = dp[i].setdefault(before_leader, {})
                        bucket.setdefault(after_state, placement)

    best_slice = _NEG_INF
    best_placement = None
    for slices_left in sorted(dp[optimal].get(0, {})):
        if best_slice < slices_left <= 0:
            best_slice = slices_left
            best_placement = dp[optimal][0][slices_left]
    return best_placement


def _prune_node(d: _Domain, threshold: int, leader_required: bool) -> None:
    """pruneDomainNodeBelowThreshold."""
    if d.slice_state < threshold:
        d.clear_state()
        return
    if leader_required and d.leader_state > 0 \
            and d.slice_state_with_leader < threshold:
        d.clear_leader_capacity()


def prune_below_threshold(snapshot, domains: list[_Domain], threshold: int,
                          slice_size: int, slice_level_idx: int, level: int,
                          leader_required: bool) -> None:
    """pruneDomainsBelowThreshold: zero out sub-threshold children, then
    re-aggregate each candidate subtree and prune it too."""
    for d in domains:
        for c in d.children:
            _prune_node(c, threshold, leader_required)
    for d in domains:
        snapshot.bubble_up(d, slice_size, slice_level_idx, level,
                           leader_required)
        _prune_node(d, threshold, leader_required)


def find_best_domains(snapshot, state) -> tuple[Optional[list[_Domain]],
                                                int]:
    """findBestDomainsForBalancedPlacement: per sibling-group of the
    requested level, compute the balance threshold via a greedy probe,
    prune, and keep the group with the highest threshold (fewest domains
    on ties)."""
    slice_count = state.count // state.slice_size
    if state.requested_level_idx == 0:
        groups = [list(snapshot.domains_per_level[0].values())]
    else:
        parents = sorted(
            snapshot.domains_per_level[state.requested_level_idx - 1]
            .values(), key=lambda d: d.values)
        groups = [p.children for p in parents]

    best_threshold = 0
    best_count = 0
    best: Optional[list[_Domain]] = None
    leader_required = state.leader_count > 0

    for siblings in groups:
        if not siblings:
            continue
        cand = clone_domains(list(siblings))
        lower = [c for d in cand for c in d.children] \
            if state.requested_level_idx < state.slice_level_idx else cand
        fits, selected, lwl, last = evaluate_greedy(
            snapshot, lower, slice_count, state.leader_count)
        if not fits:
            continue
        threshold = threshold_value(slice_count, selected, lwl, last)
        threshold_with_reservation = threshold
        if state.leader_count > 0 and last is not None:
            threshold_with_reservation = min(
                threshold, last.slice_state_with_leader)
        if threshold < best_threshold:
            continue
        prune_below_threshold(snapshot, cand, threshold, state.slice_size,
                              state.slice_level_idx,
                              state.requested_level_idx, leader_required)
        fits2, count2, _, _ = evaluate_greedy(snapshot, cand, slice_count,
                                              state.leader_count)
        if not fits2 and threshold_with_reservation < threshold:
            # Retry with a lower threshold that reserves leader capacity.
            if threshold_with_reservation <= 0 or \
                    threshold_with_reservation < best_threshold:
                continue
            threshold = threshold_with_reservation
            cand = clone_domains(list(siblings))
            prune_below_threshold(snapshot, cand, threshold,
                                  state.slice_size, state.slice_level_idx,
                                  state.requested_level_idx,
                                  leader_required)
            fits2, count2, _, _ = evaluate_greedy(
                snapshot, cand, slice_count, state.leader_count)
        if not fits2:
            continue
        if threshold > best_threshold or (
                threshold == best_threshold and count2 < best_count):
            best_threshold = threshold
            best_count = count2
            best = cand
    return best, best_threshold


def place_slices_balanced(snapshot, domains: list[_Domain],
                          slice_count: int, leader_count: int,
                          slice_size: int, threshold: int
                          ) -> tuple[Optional[list[_Domain]], str]:
    """placeSlicesOnDomainsBalanced: give every selected domain the
    threshold share, distribute the remainder, reserve the leader."""
    result = select_optimal_domain_set(snapshot, domains, slice_count,
                                       leader_count, slice_size, False)
    if result is None:
        return None, ("TAS Balanced Placement: cannot find optimal domain "
                      "set to fit the request")
    if slice_count < len(result) * threshold:
        return None, ("TAS Balanced Placement: not enough slices to meet "
                      "the threshold")
    result = snapshot._sorted_with_leader(result, False)
    extra = slice_count - len(result) * threshold
    leaders_left = leader_count
    for d in result:
        if leaders_left > 0:
            take = min(d.slice_state_with_leader - threshold, extra)
            d.leader_state = 1
            leaders_left -= 1
        elif extra > 0:
            take = min(d.slice_state - threshold, extra)
            d.leader_state = 0
        else:
            d.leader_state = 0
            take = 0
        d.state = (threshold + take) * slice_size
        d.slice_state = threshold + take
        d.slice_state_with_leader = d.slice_state
        d.state_with_leader = d.state - d.leader_state
        extra -= take
    if extra > 0 or leaders_left > 0:
        return None, ("TAS Balanced Placement: not all slices or leaders "
                      "could be placed")
    return result, ""


def apply(snapshot, state, threshold: int, cand: list[_Domain]
          ) -> tuple[Optional[list[_Domain]], int, str]:
    """applyBalancedPlacementAlgorithm: pick the optimal set (entropy
    priority) at the requested level, drop to its children when the slice
    level is deeper, then balance-place the slices."""
    slice_count = state.count // state.slice_size
    if state.requested_level_idx < state.slice_level_idx:
        result = select_optimal_domain_set(
            snapshot, cand, slice_count, state.leader_count,
            state.slice_size, True)
        if result is None:
            return None, 0, ("TAS Balanced Placement: cannot find optimal "
                             "domain set to fit the request")
        cand = [c for d in result for c in d.children]
        fit_level_idx = state.requested_level_idx + 1
    else:
        fit_level_idx = state.requested_level_idx
    placed, reason = place_slices_balanced(
        snapshot, cand, slice_count, state.leader_count, state.slice_size,
        threshold)
    if reason:
        return None, 0, reason
    return placed, fit_level_idx, ""
