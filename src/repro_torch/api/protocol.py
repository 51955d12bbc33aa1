"""The ``SplitModel`` protocol: the contract between split-model adapters
and training engines (counterpart of ``repro/api/protocol.py``).

  * ``make_client(li)``/``make_server(li)`` return ``{"trainable": ...,
    "state": ...}`` dicts of tensors; ``trainable`` holds what the
    optimizer updates, ``state`` the statistics it does not (BatchNorm
    running statistics; ``{}`` if none).  Each call returns tensors of its
    own.
  * Server trainables are keyed ``layer{l}``/``head`` so Eq. (1) matches
    layers by name across heterogeneous cut layers.
  * Nets with the same cut layer have the same tree structure (paper
    §III-B: the same init seed), so cohorts can be stacked along a lane
    axis.
  * The adapter has a ``device``: where its nets live.

Evaluation goes through ``client_forward`` and ``server_forward``, and so
does training unless the adapter defines the optional loss hooks, which
``core.strategies.client_loss_fn`` / ``server_loss_fn`` then use in every
engine:

  * ``client_loss(trainable, state, x, y) -> (loss, (h, new_state))``
  * ``server_loss(trainable, state, h, li, y) -> (loss, new_state)``

``BackboneSplitModel`` adds each side's MoE router aux loss there.
"""
from __future__ import annotations

from typing import Any, Dict, Protocol, Sequence, Tuple, runtime_checkable


@runtime_checkable
class SplitModel(Protocol):
    """Adapter splitting a layered network at a per-client cut layer."""

    @property
    def num_layers(self) -> int:
        """Depth L of the full network; valid cut layers are 1..L-1."""
        ...

    def make_client(self, li: int) -> Dict[str, Any]:
        """Client net for cut layer ``li``: layers 1..li + exit head."""
        ...

    def make_server(self, li: int) -> Dict[str, Any]:
        """Server net for cut layer ``li``: layers li+1..L + head."""
        ...

    def client_forward(self, trainable: Any, state: Any, x: Any, train: bool
                       ) -> Tuple[Any, Any, Any]:
        """``(h, client_logits, new_state)``: features at the cut and the
        early-exit logits."""
        ...

    def server_forward(self, trainable: Any, state: Any, h: Any, li: int,
                       train: bool) -> Tuple[Any, Any]:
        """``(server_logits, new_state)`` from transmitted features ``h``."""
        ...

    def stack_clients(self, trees: Sequence[Any]) -> Any:
        """Stack same-structure per-client trees along a lane axis."""
        ...

    def unstack(self, stacked: Any, n: int) -> list:
        """Inverse of :meth:`stack_clients`."""
        ...


_REQUIRED_METHODS = ("make_client", "make_server", "client_forward",
                     "server_forward", "stack_clients", "unstack")


def assert_split_model(model: Any) -> None:
    """Raise ``TypeError`` naming what is missing if ``model`` does not
    conform to :class:`SplitModel` (``TrainSession`` calls this first, so
    a bad adapter fails at the facade, not inside a step)."""
    missing = [m for m in _REQUIRED_METHODS
               if not callable(getattr(model, m, None))]
    if not hasattr(model, "num_layers"):
        missing.append("num_layers")
    if missing or not isinstance(model, SplitModel):
        what = f"missing or non-callable: {missing}" if missing else \
            "see repro_torch.api.protocol.SplitModel"
        raise TypeError(f"{type(model).__name__} does not implement the "
                        f"SplitModel protocol ({what})")
