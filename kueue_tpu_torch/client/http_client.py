"""Remote typed client over the serving endpoint's REST API, ported
from ``kueue_tpu/client/http_client.py``.

Out-of-process counterpart of clientset.KueueClient for the read surface
the visibility/serving endpoint exposes (visibility/http_server.py):
cluster queue summaries, workloads, per-CQ pending positions, metrics,
health — the same data kueuectl and the dashboard consume.
"""

from __future__ import annotations

import json
import urllib.request


class RemoteClient:
    def __init__(self, base_url: str, timeout: float = 5.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _get(self, path: str):
        req = urllib.request.Request(self.base_url + path)
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            body = resp.read().decode()
        return body

    def _get_json(self, path: str):
        return json.loads(self._get(path))

    def healthz(self) -> bool:
        try:
            return self._get_json("/healthz").get("status") == "ok"
        except OSError:
            return False

    def metrics_text(self) -> str:
        return self._get("/metrics")

    def list_cluster_queues(self) -> list[dict]:
        return self._get_json("/clusterqueues")

    def list_workloads(self) -> list[dict]:
        return self._get_json("/workloads")

    def pending_workloads(self, cluster_queue: str) -> dict:
        return self._get_json(
            f"/clusterqueues/{cluster_queue}/pendingworkloads")

    def pending_workloads_many(self, cluster_queues: list[str]
                               ) -> dict[str, dict]:
        """Fan the per-CQ pending queries out over bounded workers
        (pkg/util/parallelize Until — the reference uses the same
        pattern for its API-call fan-outs). Raises the first error."""
        from kueue_tpu_torch.utils.parallelize import until

        out: dict[str, dict] = {}

        def piece(i: int) -> None:
            cq = cluster_queues[i]
            out[cq] = self.pending_workloads(cq)

        err = until(len(cluster_queues), piece)
        if err is not None:
            raise err
        return out

    def debug_dump(self) -> dict:
        return self._get_json("/debug/dump")
