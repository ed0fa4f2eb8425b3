"""Typed client layer — the client-go analog, ported from
``kueue_tpu/client``.

The reference generates a full clientset/informers/listers stack
(client-go/, ~27k LoC) so external consumers program against typed
interfaces instead of raw API machinery. Here the same roles are:

  * clientset.KueueClient — typed per-kind CRUD handles over a running
    engine (client-go/clientset/versioned/typed/...);
  * informers.Informer — event-driven local caches with
    add/update/delete handlers (client-go/informers);
  * listers.Listers — read-only indexed label-selectable views per kind
    (client-go/listers: List(selector)/Get + the by-CQ/by-queue/
    by-phase/by-cohort indices kueue's controllers query);
  * applyconfigurations.ApplyEngine — typed apply builders with
    server-side-apply field-manager ownership and conflicts
    (client-go/applyconfiguration);
  * http_client.RemoteClient — the same read surface over the serving
    endpoint's REST API for out-of-process consumers.
"""

from kueue_tpu_torch.client.applyconfigurations import (  # noqa: F401
    ApplyConflict,
    ApplyEngine,
    ClusterQueueApply,
    LocalQueueApply,
    WorkloadApply,
)
from kueue_tpu_torch.client.clientset import KueueClient  # noqa: F401
from kueue_tpu_torch.client.http_client import RemoteClient  # noqa: F401
from kueue_tpu_torch.client.informers import Informer  # noqa: F401
from kueue_tpu_torch.client.listers import (  # noqa: F401
    LabelSelector,
    Listers,
    Requirement,
)
