"""Training-event hook registry: actions registered on named events, fired
with keyword context.

Port of ``yolort_tpu/utils/callbacks.py`` (the same ``EVENTS``)."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

EVENTS = (
    "on_pretrain_routine_start",
    "on_train_start",
    "on_train_epoch_start",
    "on_train_batch_end",
    "on_train_epoch_end",
    "on_val_start",
    "on_val_end",
    "on_fit_epoch_end",
    "on_model_save",
    "on_train_end",
)


class Callbacks:
    def __init__(self):
        self._actions: Dict[str, List[dict]] = {e: [] for e in EVENTS}

    def register_action(self, hook: str, name: str = "", callback: Optional[Callable] = None):
        if hook not in self._actions:
            raise ValueError(f"unknown hook '{hook}' (valid: {EVENTS})")
        if not callable(callback):
            raise ValueError("callback must be callable")
        self._actions[hook].append({"name": name, "callback": callback})

    def get_registered_actions(self, hook: Optional[str] = None):
        return self._actions[hook] if hook else self._actions

    def run(self, hook: str, *args, **kwargs):
        if hook not in self._actions:
            raise ValueError(f"unknown hook '{hook}'")
        for action in self._actions[hook]:
            action["callback"](*args, **kwargs)
