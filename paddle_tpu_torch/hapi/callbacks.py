"""hapi callbacks: the port of paddle_tpu/hapi/callbacks.py (``Callback``,
``CallbackList``, ``ProgBarLogger``, ``EarlyStopping``,
``LRScheduler``).

``ModelCheckpoint`` saves through the crash-safe checkpoint manager
(``distributed/checkpoint/manager.py``), which is not ported yet
(ROADMAP queue A8): it raises, and so does ``Model.fit(save_dir=...)``.
``Model.save`` / ``Model.load`` work.
"""
from __future__ import annotations

import time

import numpy as np

from ..optimizer.lr import LRScheduler as _Schedule

__all__ = ["Callback", "CallbackList", "EarlyStopping", "LRScheduler",
           "ModelCheckpoint", "ProgBarLogger"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass


class CallbackList:
    """Calls each ``on_*`` hook of every callback, in order."""

    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def dispatch(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)

            return dispatch
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._start = time.time()
        if self.verbose and self.params.get("epochs"):
            print(f"Epoch {epoch + 1}/{self.params['epochs']}")

    def _fmt(self, logs):
        parts = []
        for k, v in (logs or {}).items():
            if isinstance(v, (list, tuple, np.ndarray)):
                v = v[0] if len(np.atleast_1d(v)) else v
            if isinstance(v, float):
                parts.append(f"{k}: {v:.4f}")
            else:
                parts.append(f"{k}: {v}")
        return " - ".join(parts)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and (step + 1) % self.log_freq == 0:
            print(f"step {step + 1}/{self.steps or '?'} - {self._fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dur = time.time() - self._start
            print(f"Epoch {epoch + 1} done ({dur:.1f}s) - {self._fmt(logs)}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval - {self._fmt(logs)}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None, max_to_keep=None,
                 async_save=False):
        raise NotImplementedError(
            "ModelCheckpoint (epoch checkpoints through the crash-safe "
            "CheckpointManager) is not ported yet: ROADMAP queue A8; "
            "Model.save / Model.load work")


class EarlyStopping(Callback):
    """Stops ``fit`` when the evaluated ``monitor`` has not improved by
    ``min_delta`` for ``patience`` evaluations."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.wait = 0
        self.best = None
        self.stopped_epoch = 0

    def _better(self, cur):
        if self.best is None:
            return True
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple, np.ndarray)):
            cur = float(np.atleast_1d(cur)[0])
        if self._better(cur):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    """Steps the optimizer's `optimizer.lr.LRScheduler` after each batch
    (``by_step``) or each epoch (``by_epoch``)."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        if opt is not None and isinstance(opt._learning_rate, _Schedule):
            return opt._learning_rate
        return None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s is not None and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s is not None and self.by_epoch:
            s.step()
