"""``paddle.Model`` — port of ``paddle_tpu/hapi/model.py``: eager training
under PyTorch's autograd (the graphed steps are ``parallel.ParallelEngine``'s).

The network runs where its parameters are (on the card unless it was
built on the CPU): each batch the loader yields on the CPU is moved to the
device of the network's first parameter before the forward, and numpy
inputs become tensors there. :meth:`Model.predict_batch` returns numpy
(a bf16 output as an ``ml_dtypes.bfloat16`` array, as in the JAX
package). :meth:`Model.save` / :meth:`Model.load` write and read the JAX
package's pickle format (``framework.io_state``), so either package loads
the other's ``.pdparams``. ``prepare(amp_configs=)`` trains under
``amp.auto_cast`` with ``amp.GradScaler``, as in the JAX package.
"""
from __future__ import annotations

import itertools
import os
from typing import List

import numpy as np

import torch

from ..framework.io_state import _host, from_numpy
from ..framework.io_state import load as _load
from ..framework.io_state import save as _save
from ..io import DataLoader
from ..metric import Metric
from . import callbacks as cbks_mod


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self.stop_training = False

    # ------------------------------------------------------------------ prep
    def prepare(self, optimizer=None, loss=None, metrics=None, amp_configs=None):
        """``amp_configs``: "O1"/"O2" or a dict with ``level`` plus
        GradScaler/auto_cast knobs (init_loss_scaling, incr/decr ratios,
        custom_white_list/custom_black_list); training then runs under
        ``paddle.amp.auto_cast`` with dynamic loss scaling."""
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            self._metrics = metrics if isinstance(metrics, (list, tuple)) else [metrics]
        else:
            self._metrics = []
        # parse/validate FIRST, commit to self only once everything checks
        # out — a ValueError must not leave the Model half-configured
        level, white, black, scaler = "O0", None, None, None
        if amp_configs:
            if isinstance(amp_configs, str):
                level, cfg = amp_configs, {}
            else:
                cfg = dict(amp_configs)
                level = cfg.pop("level", "O1")
            if level not in ("O0", "O1", "O2"):
                raise ValueError(f"amp level must be O0/O1/O2, got {level!r}")
            white = cfg.pop("custom_white_list", None)
            black = cfg.pop("custom_black_list", None)
            scaler_kw = {k: cfg.pop(k) for k in (
                "init_loss_scaling", "incr_ratio", "decr_ratio",
                "incr_every_n_steps", "decr_every_n_nan_or_inf",
                "use_dynamic_loss_scaling") if k in cfg}
            if cfg:
                raise ValueError(f"unknown amp_configs keys: {sorted(cfg)}")
            if level != "O0":
                from ..amp import GradScaler, decorate

                scaler = GradScaler(**scaler_kw)
                if level == "O2":
                    # reference O2 contract: params cast to bf16, optimizer
                    # keeps fp32 master weights (amp.decorate)
                    decorate(self.network, optimizers=optimizer, level="O2")
        self._amp_level = level
        self._amp_custom_white = white
        self._amp_custom_black = black
        self._scaler = scaler

    # ---------------------------------------------------------------- device
    def _device(self):
        """The device of the network's first parameter (or buffer); None
        for a network that has neither."""
        for t in itertools.chain(self.network.parameters(),
                                 self.network.buffers()):
            return t.device
        return None

    def _to_device(self, v):
        """``v`` with its tensors and numpy arrays on the network's
        device, through lists, tuples and dicts."""
        dev = self._device()
        if dev is None:
            return v
        if isinstance(v, torch.Tensor):
            return v.to(dev, non_blocking=True)
        if isinstance(v, np.ndarray):
            return from_numpy(v, dev)
        if isinstance(v, (list, tuple)):
            return type(v)(self._to_device(a) for a in v)
        if isinstance(v, dict):
            return {k: self._to_device(a) for k, a in v.items()}
        return v

    # ------------------------------------------------------------------ steps
    def _compute_loss(self, outputs, labels):
        if self._loss is None:
            raise RuntimeError("call prepare(loss=...) first")
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        lbls = labels if isinstance(labels, (list, tuple)) else [labels]
        if isinstance(self._loss, (list, tuple)):
            # per-output loss fns summed (ref Model multi-output contract)
            if not (len(self._loss) == len(outs) == len(lbls)):
                raise ValueError(
                    f"loss list/outputs/labels length mismatch: "
                    f"{len(self._loss)}/{len(outs)}/{len(lbls)}")
            parts = [fn(o, l) for fn, o, l in zip(self._loss, outs, lbls)]
            total = parts[0]
            for p in parts[1:]:
                total = total + p
            return total
        return self._loss(*outs, *lbls)

    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        inputs, labels = self._to_device(list(inputs)), self._to_device(labels)
        from ..amp import auto_cast

        amp_on = getattr(self, "_amp_level", "O0") != "O0"
        with auto_cast(enable=amp_on,
                       level=self._amp_level if amp_on else "O1",
                       custom_white_list=getattr(self, "_amp_custom_white",
                                                 None),
                       custom_black_list=getattr(self, "_amp_custom_black",
                                                 None)):
            outputs = self.network(*inputs)
            loss = self._compute_loss(outputs, labels)
        scaler = getattr(self, "_scaler", None)
        if scaler is not None:
            scaler.scale(loss).backward()
            if update:
                scaler.step(self._optimizer)
                scaler.update()
                self._optimizer.clear_grad()
        else:
            loss.backward()
            if update:
                self._optimizer.step()
                self._optimizer.clear_grad()
        metrics = self._update_metrics(outputs, labels)
        return ([float(loss.item())], metrics) if metrics else [float(loss.item())]

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        inputs, labels = self._to_device(list(inputs)), self._to_device(labels)
        with torch.no_grad():
            outputs = self.network(*inputs)
            loss = self._compute_loss(outputs, labels) if self._loss else None
        metrics = self._update_metrics(outputs, labels)
        out = [float(loss.item())] if loss is not None else []
        return (out, metrics) if metrics else out

    def predict_batch(self, inputs):
        self.network.eval()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        inputs = self._to_device(list(inputs))
        with torch.no_grad():
            outputs = self.network(*inputs)
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        return [_host(o) for o in outs]

    def _update_metrics(self, outputs, labels):
        vals = []
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        lbls = labels if isinstance(labels, (list, tuple)) else [labels]
        for m in self._metrics:
            res = m.compute(*outs, *lbls)
            m.update(res)
            vals.append(m.accumulate())
        return vals

    # ------------------------------------------------------------------- fit
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        if not isinstance(train_data, DataLoader):
            train_loader = DataLoader(train_data, batch_size=batch_size, shuffle=shuffle,
                                      drop_last=drop_last, num_workers=num_workers)
        else:
            train_loader = train_data
        eval_loader = None
        if eval_data is not None:
            eval_loader = eval_data if isinstance(eval_data, DataLoader) else DataLoader(
                eval_data, batch_size=batch_size, num_workers=num_workers)

        cbks = cbks_mod.config_callbacks(
            callbacks, model=self, epochs=epochs, steps=self._safe_len(train_loader),
            log_freq=log_freq, save_freq=save_freq, save_dir=save_dir, verbose=verbose,
            metrics=["loss"] + [self._flat_names()] if self._metrics else ["loss"])

        cbks.on_begin("train")
        step_count = 0
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, batch in enumerate(train_loader):
                cbks.on_batch_begin("train", step, logs)
                ins, lbl = self._split_batch(batch)
                res = self.train_batch(ins, lbl,
                                       update=(step + 1) % accumulate_grad_batches == 0)
                logs = self._make_logs(res)
                logs["step"] = step
                logs["batch_size"] = self._batch_size_of(ins)
                cbks.on_batch_end("train", step, logs)
                step_count += 1
                if num_iters is not None and step_count >= num_iters:
                    self.stop_training = True
                    break
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self._run_eval(eval_loader, cbks)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cbks.on_epoch_end(epoch, logs)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(os.path.join(save_dir, str(epoch)))
        if save_dir:
            self.save(os.path.join(save_dir, "final"))
        cbks.on_end("train", logs if "logs" in dir() else {})

    def _run_eval(self, eval_loader, cbks):
        for m in self._metrics:
            m.reset()
        cbks.on_begin("eval")
        logs = {}
        for step, batch in enumerate(eval_loader):
            cbks.on_batch_begin("eval", step, logs)
            ins, lbl = self._split_batch(batch)
            res = self.eval_batch(ins, lbl)
            logs = self._make_logs(res)
            cbks.on_batch_end("eval", step, logs)
        cbks.on_end("eval", logs)
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2, num_workers=0,
                 callbacks=None, num_iters=None):
        loader = eval_data if isinstance(eval_data, DataLoader) else DataLoader(
            eval_data, batch_size=batch_size, num_workers=num_workers)
        for m in self._metrics:
            m.reset()
        logs = {}
        for step, batch in enumerate(loader):
            ins, lbl = self._split_batch(batch)
            res = self.eval_batch(ins, lbl)
            logs = self._make_logs(res)
            if num_iters is not None and step + 1 >= num_iters:
                break
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0, stack_outputs=False,
                verbose=1, callbacks=None):
        loader = test_data if isinstance(test_data, DataLoader) else DataLoader(
            test_data, batch_size=batch_size, num_workers=num_workers)
        outputs = []
        has_label = self._loss is not None
        for batch in loader:
            ins, _ = self._split_batch(batch, has_label=has_label)
            outputs.append(self.predict_batch(ins))
        if stack_outputs:
            n_out = len(outputs[0])
            return [np.concatenate([o[i] for o in outputs]) for i in range(n_out)]
        return outputs

    # ------------------------------------------------------------------- io
    def save(self, path, training=True):
        """``path.pdparams``: the network's parameters (as parameters) and
        persistable buffers; ``path.pdopt`` (``training``): the
        optimizer's state."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        _save(self.network.state_dict(keep_vars=True), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Reads :meth:`save`'s files (or the JAX package's) onto the
        network's device, in place."""
        dev = self._device() or "cpu"
        sd = _load(path + ".pdparams", device=dev)
        self.network.set_state_dict(sd)
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None and os.path.exists(opt_path):
            self._optimizer.set_state_dict(_load(opt_path, device=dev))

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        from .summary import summary as _summary

        return _summary(self.network, input_size, dtypes=dtype)

    # ---------------------------------------------------------------- helpers
    @staticmethod
    def _safe_len(loader):
        try:
            return len(loader)
        except TypeError:
            return None

    def _flat_names(self):
        names = []
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    def _split_batch(self, batch, has_label=True):
        if isinstance(batch, (list, tuple)):
            if len(batch) >= 2 and has_label:
                return list(batch[:-1]), batch[-1]
            return list(batch), None
        return [batch], None

    @staticmethod
    def _batch_size_of(ins):
        t = ins[0]
        try:
            return t.shape[0]
        except Exception:
            return 1

    def _make_logs(self, res):
        logs = {}
        if isinstance(res, tuple):
            losses, metrics = res
            logs["loss"] = losses[0] if isinstance(losses, list) else losses
            for m, v in zip(self._metrics, metrics):
                n = m.name()
                logs[n if isinstance(n, str) else n[0]] = v
        else:
            logs["loss"] = res[0] if isinstance(res, list) else res
        return logs
