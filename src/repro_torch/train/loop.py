"""The LM training loop: port of ``repro.train.loop`` for one device.

* ``make_train_step``: the gradient of ``lm.lm_loss`` (``torch.autograd``
  over the parameter leaves; a leaf the loss does not reach gets the
  reference's zero gradient), microbatch accumulation (the batch split
  along axis 0, the gradients summed in float32 zeros, then divided, as
  the reference's ``lax.scan`` does), optional int8 compression with
  error feedback when residuals are passed, AdamW / SGD
  (``optim.optimizer.apply_updates``) and the NaN guard: a non-finite loss
  keeps the old parameters and optimizer state and counts the skip, with
  ``torch.where`` on the device (no host read a step);
* ``Trainer``: data -> step -> metrics -> checkpoints -> restart.
  ``restore_or_init`` resumes from the latest checkpoint (the reference's
  format through ``repro_torch.checkpoint.CheckpointManager``: trees
  ``params`` and ``opt`` = {step, mu, nu}, the pipeline state in
  ``extra``); ``request_stop()`` (wire it to SIGTERM) checkpoints at the
  next step boundary; ``history`` holds the logged metrics as floats (the
  only host reads of a run, at the log steps).

The step updates the parameters and the optimizer state IN PLACE, as the
reference's jitted step donates their buffers: a caller that needs the
old values clones them first.
The reference's ``Trainer.fit`` calls its step without residuals, so its
``grad_compression`` never compresses; the port's ``Trainer`` does the
same (ROADMAP §3). A mesh raises: one card has no mesh.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig, OptimizerConfig, RunConfig
from repro_torch.devices import resolve_device
from repro_torch.models import lm
from repro_torch.optim import compression
from repro_torch.optim.optimizer import (OptState, apply_updates,
                                         init_opt_state, leafwise, leaves)


def make_train_step(cfg: ArchConfig, opt_cfg: OptimizerConfig, mesh=None,
                    rules=None, microbatches: int = 1,
                    loss_fn: Optional[Callable] = None):
    """Build the train step: ``step(params, opt, batch[, residuals])`` ->
    ``(params, opt, metrics[, residuals])``, metrics 0-d tensors (loss,
    ppl, lr, grad_norm, skipped). ``microbatches > 1`` splits the batch
    along axis 0 and accumulates the gradients. Params and opt are updated
    in place."""
    if mesh is not None or rules is not None:
        raise NotImplementedError("one card has no mesh: sharding comes "
                                  "with the multi-card slice")
    loss_fn = loss_fn or (lambda p, b: lm.lm_loss(p, b, cfg))

    def grads_of(params, batch):
        live = leafwise(lambda t: t.detach().requires_grad_(True), params)
        flat = leaves(live)
        with torch.enable_grad():
            loss, metrics = loss_fn(live, batch)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        it = iter(g if g is not None else torch.zeros_like(p)
                  for g, p in zip(grads, flat))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                leafwise(lambda _: next(it), params))

    def step(params, opt: OptState, batch, residuals=None):
        if microbatches > 1:
            def split(x):
                return x.reshape((microbatches, x.shape[0] // microbatches)
                                 + tuple(x.shape[1:]))
            mb = {k: split(v) for k, v in batch.items()}
            gsum = leafwise(lambda p: torch.zeros(p.shape,
                                                  dtype=torch.float32,
                                                  device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
            for i in range(microbatches):
                loss, _, grads = grads_of(params,
                                          {k: v[i] for k, v in mb.items()})
                leafwise(lambda a, g: a.add_(g), gsum, grads)
                lsum = lsum + loss
                del grads
            grads = leafwise(lambda g: g / microbatches, gsum)
            loss = lsum / microbatches
            metrics = {"loss": loss, "ppl": torch.exp(loss)}
        else:
            loss, metrics, grads = grads_of(params, batch)

        new_res = residuals
        if opt_cfg.grad_compression and residuals is not None:
            q, s, new_res = compression.tree_compress(grads, residuals)
            grads = compression.tree_decompress(q, s)

        finite = torch.isfinite(loss)
        new_params, new_opt, opt_metrics = apply_updates(
            params, grads, opt, opt_cfg, finite=finite)
        metrics = {**metrics, **opt_metrics,
                   "skipped": (~finite).to(torch.int32)}
        if new_res is not None:
            return new_params, new_opt, metrics, new_res
        return new_params, new_opt, metrics

    return step


class Trainer:
    """Drives the loop: data -> step -> metrics -> checkpoints -> restart,
    on ``device`` (the GPU unless asked otherwise). ``checkpoints=False``
    writes and reads none (a run whose state is too large to copy to the
    host); otherwise the reference's schedule: every
    ``run.checkpoint_every`` steps, on a stop request and at the last
    step."""

    def __init__(self, run: RunConfig, stream, mesh=None,
                 loss_fn: Optional[Callable] = None, device=None,
                 checkpoints: bool = True):
        if mesh is not None:
            raise NotImplementedError("one card has no mesh: sharding comes "
                                      "with the multi-card slice")
        self.run = run
        self.cfg = run.arch
        self.device = resolve_device(device)
        if loss_fn is None:
            lm.check_trainable(self.cfg, self.device)
        self.stream = stream
        self.ckpt = (CheckpointManager(run.checkpoint_dir,
                                       keep=run.keep_checkpoints)
                     if checkpoints else None)
        self._stop = False
        self.step_fn = make_train_step(self.cfg, run.optimizer,
                                       microbatches=run.microbatches,
                                       loss_fn=loss_fn)
        self.history: list = []

    def request_stop(self):   # wire to SIGTERM for preemption handling
        self._stop = True

    def restore_or_init(self, init_params_fn) -> Tuple[Any, OptState, int]:
        latest = self.ckpt.latest_step() if self.ckpt else None
        params = init_params_fn()
        opt = init_opt_state(params, self.run.optimizer)
        if latest is None:
            return params, opt, 0
        opt_d = {"step": opt.step, "mu": opt.mu, "nu": opt.nu}
        restored, extra = self.ckpt.restore(
            latest, {"params": params, "opt": opt_d})
        self.stream.load_state_dict(extra["pipeline"])
        return restored["params"], OptState(**restored["opt"]), latest

    def fit(self, params, opt: OptState, start_step: int, num_steps: int):
        step = start_step
        while step < num_steps and not self._stop:
            batch = self.stream.next_batch()
            params, opt, metrics = self.step_fn(params, opt, batch)
            step += 1
            if step % self.run.log_every == 0 or step == num_steps:
                self.history.append(
                    {k: float(v) for k, v in metrics.items()})
            if self.ckpt is not None and (
                    step % self.run.checkpoint_every == 0 or self._stop
                    or step == num_steps):
                opt_d = {"step": opt.step, "mu": opt.mu, "nu": opt.nu}
                self.ckpt.save(step, {"params": params, "opt": opt_d},
                               extra={"pipeline": self.stream.state_dict()})
        if self.ckpt is not None:
            self.ckpt.wait()
        return params, opt, step
