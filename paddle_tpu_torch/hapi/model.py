"""``paddle.Model``, the Keras-like high-level API: the port of
paddle_tpu/hapi/model.py (``InputSpec``, ``Model``: ``prepare``,
``train_batch``, ``eval_batch``, ``predict_batch``, ``fit``,
``evaluate``, ``predict``, ``save``, ``load``, ``parameters``,
``summary``).

The network is a ``torch.nn.Module``; a batch's inputs and labels
(numpy arrays or torch tensors) are moved to the device of its first
parameter, so a network built on the card trains there. A step is eager
PyTorch: the forward, ``loss.backward()``, ``optimizer.step()`` and
``clear_grad()`` (with an fp16 ``amp_configs``, the `amp.GradScaler`'s
``scale`` and ``minimize``).

Host syncs are the reference's. ``train_batch(sync=False)`` leaves the
loss on the device; ``fit`` reads it back only at log boundaries, at an
epoch's last step, or every step when metrics or user callbacks need it.
A metric reads its inputs back on each batch, as the reference's
``_to_np`` does. ``fit(prefetch=True)`` stages batches on the device
through `io.DevicePrefetcher` (``input_pipeline_stats`` after the fit).

``save`` / ``load`` write and read the reference's files
(`framework.io`, ``.pdparams`` and ``.pdopt``) in the reference's
layouts (`convert`: Linear weights transposed; optimizer state keyed
``param_<rank>`` in ``named_parameters()`` order), so files cross
between the packages.

Not ported yet: ``fit(save_dir=...)``, which saves through
``ModelCheckpoint`` (ROADMAP queue A8), and ``num_workers > 0`` (the
loader's workers, A10b): both raise.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..convert import (_to_numpy, optimizer_state_from_jax,
                       optimizer_state_to_jax, state_dict_from_jax,
                       state_dict_to_jax)
from ..framework.io import load as _load
from ..framework.io import save as _save
from ..io import DataLoader, Dataset, DevicePrefetcher
from ..metric import Metric
from ..observability import registry
from .callbacks import CallbackList, ModelCheckpoint, ProgBarLogger

__all__ = ["InputSpec", "Model"]


class InputSpec:
    """A static input's description (shape, dtype, name)."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = list(shape)
        self.dtype = dtype
        self.name = name

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = _to_list(inputs)
        self._labels = _to_list(labels)
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._scaler = None
        self._amp_level = None
        self.stop_training = False
        self.mode = "train"

    # -- setup ------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        """Bind the optimizer, the loss and the metrics. ``amp_configs``
        (a level, or a dict with ``level``, ``dtype`` and
        ``init_loss_scaling``) records the level and, for float16, makes
        a `GradScaler`; it does not cast the network (`amp.decorate`
        does)."""
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError(
                    f"metrics must be paddle_tpu_torch.metric.Metric, got "
                    f"{type(m).__name__}")
        if amp_configs:
            from ..amp import GradScaler

            cfg = amp_configs if isinstance(amp_configs, dict) else {}
            self._amp_level = cfg.get("level", "O1") if cfg else amp_configs
            if cfg.get("dtype", "bfloat16") == "float16":
                self._scaler = GradScaler(init_loss_scaling=cfg.get(
                    "init_loss_scaling", 2.0 ** 15))
        return self

    # -- single-batch ops --------------------------------------------------
    def _device(self):
        p = next(self.network.parameters(), None)
        return torch.device("cpu") if p is None else p.device

    def _on_device(self, xs):
        dev = self._device()
        return [x.to(dev) if isinstance(x, torch.Tensor)
                else torch.from_numpy(np.asarray(x)).to(dev)
                for x in _to_list(xs)]

    def _compute_loss(self, outputs, labels):
        outs = _to_list(outputs)
        if self._loss is None:
            return outs[0]
        return self._loss(*(outs + _to_list(labels)))

    def _update_metrics(self, outputs, labels):
        out = []
        for m in self._metrics:
            m.update(*_to_list(m.compute(*(_to_list(outputs) + labels))))
            out.append(m.accumulate())
        return out

    def train_batch(self, inputs, labels=None, update=True, sync=True):
        """One training step. Returns ``[loss]`` (and the metrics'
        values): a host float, or with ``sync=False`` the loss as a
        device tensor, not read back."""
        self.network.train()
        self.mode = "train"
        inputs, labels = self._on_device(inputs), self._on_device(labels)
        outputs = self.network(*inputs)
        loss = self._compute_loss(outputs, labels)
        if self._scaler is not None:
            self._scaler.scale(loss).backward()
            if update:
                self._scaler.minimize(self._optimizer, loss)
        else:
            loss.backward()
            if update:
                self._optimizer.step()
                self._optimizer.clear_grad()
        metrics = self._update_metrics(outputs, labels)
        out = [float(loss.detach()) if sync else loss.detach()]
        return (out, metrics) if metrics else out

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        self.mode = "eval"
        inputs, labels = self._on_device(inputs), self._on_device(labels)
        outputs = self.network(*inputs)
        loss = self._compute_loss(outputs, labels)
        metrics = self._update_metrics(outputs, labels)
        out = [float(loss)]
        return (out, metrics) if metrics else out

    @torch.no_grad()
    def predict_batch(self, inputs):
        """The network's outputs on ``inputs`` as numpy arrays."""
        self.network.eval()
        self.mode = "predict"
        outputs = self.network(*self._on_device(inputs))
        return [_to_numpy(o) for o in _to_list(outputs)]

    # -- loops -------------------------------------------------------------
    def _make_loader(self, data, batch_size, shuffle, num_workers):
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers)
        return data       # a DataLoader, an iterable of batches, or None

    def _split_batch(self, batch):
        n_in = len(self._inputs) if self._inputs else 1
        if isinstance(batch, (list, tuple)):
            batch = list(batch)
            return batch[:n_in], batch[n_in:]
        return [batch], []

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None, prefetch=False,
            prefetch_depth=2):
        if save_dir:
            ModelCheckpoint(save_freq, save_dir)            # raises: A8
        loader = self._make_loader(train_data, batch_size, shuffle,
                                   num_workers)
        eval_loader = self._make_loader(eval_data, batch_size, False,
                                        num_workers)
        prefetcher = None
        if prefetch and loader is not None:
            if not isinstance(loader, DevicePrefetcher):
                loader = DevicePrefetcher(loader, depth=prefetch_depth,
                                          device=self._device())
            prefetcher = loader

        cbks = _to_list(callbacks)
        # user callbacks read logs["loss"] every batch as a host float:
        # the loss is read back every step only when they (or metrics)
        # are there
        has_user_cbks = bool(cbks)
        if verbose:
            cbks.append(ProgBarLogger(log_freq, verbose=verbose))
        cbk_list = CallbackList(cbks)
        cbk_list.set_model(self)
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cbk_list.set_params({
            "epochs": epochs, "steps": steps, "verbose": verbose,
            "metrics": ["loss"] + [n for m in self._metrics
                                   for n in _to_list(m.name())]})

        self.stop_training = False
        cbk_list.on_train_begin()
        global_step = 0
        logs = {}
        try:
            for epoch in range(epochs):
                cbk_list.on_epoch_begin(epoch)
                for m in self._metrics:
                    m.reset()
                logs = {}
                for step, batch in enumerate(loader):
                    cbk_list.on_train_batch_begin(step)
                    inputs, labels = self._split_batch(batch)
                    update = (step + 1) % accumulate_grad_batches == 0
                    sync = (bool(self._metrics) or has_user_cbks
                            or (bool(verbose) and (step + 1) % log_freq == 0)
                            or (steps is not None and step == steps - 1))
                    result = self.train_batch(inputs, labels, update=update,
                                              sync=sync)
                    logs = self._result_to_logs(result)
                    if sync:
                        logs.update(self._telemetry_logs())
                    cbk_list.on_train_batch_end(step, logs)
                    global_step += 1
                    if num_iters is not None and global_step >= num_iters:
                        self.stop_training = True
                        break
                logs = self._sync_logs(logs)
                cbk_list.on_epoch_end(epoch, logs)
                if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                    self.evaluate(eval_loader, batch_size=batch_size,
                                  verbose=0, callbacks=cbks,
                                  num_workers=num_workers)
                if self.stop_training:
                    break
            cbk_list.on_train_end(logs)
        finally:
            # also when a step or a callback raises: stop the producer
            # thread and release the staged batches
            if prefetcher is not None:
                self.input_pipeline_stats = prefetcher.get_stats()
                prefetcher.close()
        return self

    def _telemetry_logs(self):
        """At a log boundary: the registry's loss-scale, guard-skip and
        global-grad-norm gauges where a step published them (each read
        is lazy), else the eager GradScaler's scale."""
        out = {}
        reg = registry()
        for key, label in (("train.loss_scale", "loss_scale"),
                           ("train.guard_skipped_steps", "guard_skips"),
                           ("numerics.global_grad_norm", "grad_norm")):
            g = reg.get(key)
            v = g.value if g is not None else None
            if v is not None:
                out[label] = float(v)
        if "loss_scale" not in out and self._scaler is not None:
            out["loss_scale"] = float(self._scaler._scale)
        return out

    @staticmethod
    def _sync_logs(logs):
        """Deferred (device) losses in ``logs`` read back as floats."""
        def host(v):
            return float(v) if isinstance(v, torch.Tensor) else v

        return {k: [host(x) for x in v] if isinstance(v, list) else host(v)
                for k, v in (logs or {}).items()}

    def _result_to_logs(self, result):
        logs = {}
        if isinstance(result, tuple):
            losses, metrics = result
            logs["loss"] = losses
            for m, v in zip(self._metrics, metrics):
                for n, val in zip(_to_list(m.name()), _to_list(v)):
                    logs[n] = val
        else:
            logs["loss"] = result
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        loader = self._make_loader(eval_data, batch_size, False, num_workers)
        cbks = CallbackList(_to_list(callbacks))
        cbks.set_model(self)
        for m in self._metrics:
            m.reset()
        cbks.on_eval_begin()
        logs = {}
        for batch in loader:
            inputs, labels = self._split_batch(batch)
            logs = self._result_to_logs(self.eval_batch(inputs, labels))
        cbks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._make_loader(test_data, batch_size, False, num_workers)
        outputs = [self.predict_batch(self._split_batch(batch)[0])
                   for batch in loader]
        if stack_outputs and outputs:
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(len(outputs[0]))]
        return outputs

    # -- persistence -------------------------------------------------------
    def save(self, path, training=True):
        """``path.pdparams`` (and with ``training``, the optimizer's
        ``path.pdopt``) in the reference's format and layouts."""
        net = self.network
        _save(state_dict_to_jax(net.state_dict(), model=net, tensors=True),
              path + ".pdparams")
        if training and self._optimizer is not None:
            _save(optimizer_state_to_jax(self._optimizer.state_dict(), net,
                                         self._optimizer), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        net = self.network
        net.load_state_dict(state_dict_from_jax(_load(path + ".pdparams"),
                                                model=net))
        opt_path = path + ".pdopt"
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(opt_path)):
            self._optimizer.set_state_dict(optimizer_state_from_jax(
                _load(opt_path), net, self._optimizer))
        return self

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        """Each parameter's name, shape and size; the totals."""
        total = trainable = 0
        lines = []
        for name, p in self.network.named_parameters():
            n = p.numel()
            total += n
            if p.requires_grad:
                trainable += n
            lines.append(f"  {name:<50} {str(list(p.shape)):<24} {n}")
        print(f"{'Layer (param)':<52} {'Shape':<24} Param #\n"
              + "\n".join(lines))
        print(f"Total params: {total}\nTrainable params: {trainable}")
        return {"total_params": total, "trainable_params": trainable}
