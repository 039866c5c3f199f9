"""The training engine: train and eval steps and the epoch loop (port of
`train/engine.py`).

One engine drives any Task. A train step decodes the compact batch on the
device, runs the task's loss, backpropagates (through kernels B1-B3 on the
card for the binaural family), measures the global gradient norm, clips it
with optax's semantics, updates the parameters with the per-step learning
rate and counts the step. The epoch index enters the loss as a 0-based
float, so curriculum schedules need nothing else. The step and its phases
run in `obs.spans` spans: `engine.train_step` around `engine.decode`,
`engine.forward` (zero_grad and the loss), `engine.backward` and
`engine.optimizer` (the norm, the clip, the learning rate and AdamW); the
gradient list and, with several data ranks, their all-reduce sit between
the backward and the optimizer, in no span of their own.

The host encodes each batch with the compact codec (`data/codec.py`) and the
device decodes it; in float64 mode (the parity mode) the host ships float32
batches as they are, since the uint16 depth quantum (0.46 mm at 30 m) would
perturb gradients at ~1e-5. `fit` feeds the train steps through
`data/prefetch.py` (pinned buffers and a side stream on a card).

`fit` saves checkpoints through a `ckpt.CheckpointManager` when given one:
every `saving_checkpoints` epochs, at a new best validation metric, at the
final epoch, and on SIGTERM (the last completed epoch). It evaluates the
holdout loaders at each validation, logs the JAX fit's keys to a
`obs.MetricLogger`, and runs the negative and stuck-at-zero detectors (and
a visualization callback) on the first validation batch, and with a
profiler hook (`obs.ProfilerHook`) traces the train steps of one epoch.

Data parallelism (`group`, a `parallel.DataGroup`): the N-rank step is the
one-rank step on the global batch, as a JAX ('data',) mesh's is. Each rank
trains on its contiguous rows of every global batch
(`parallel.local_batch_slice`); the losses, BatchNorm and the random draws
are the global batch's (`parallel.global_sum`, `parallel.draw_global`),
the gradients are all-reduced and divided by N, and the norm and the clip
come from the reduced gradients, equal on every rank. The engine
broadcasts rank 0's parameters and buffers when it is built. `evaluate`
takes GLOBAL batches, each rank keeping its rows (`parallel.local_shard`,
ragged tails padded with a `_valid` mask), and all-reduces the metric sums.
`fit` logs, draws and checkpoints on rank 0 (the manager writes there), and
a SIGTERM on any rank stops every rank at the same step boundary.

A ('data', 'model') group (`parallel.MeshGroup` of dp × sp ranks) is the
JAX engine's 2-D mesh: the ranks of one data index hold the same rows and
run the same program on them, replicated over the model axis, except the
layers that split their work over it (the binaural attention with
`sp_axis`, the plain STFT front end, which the engine attaches when sp > 1).
The batch reductions, the gradient all-reduce (divided by dp), evaluation's
sums and the row slices run over the data axis; the initial broadcast, the
SIGTERM flag, rank 0's logs and checkpoints over the whole world. The model
ranks' gradients come out equal by construction, so nothing reduces them
over the model axis; on a card that needs the replicated part of the step
computed deterministically, which the engine turns on around its steps and
off after them (`deterministic_kernels`). A `DataGroup` is a mesh of one
axis.
"""

from __future__ import annotations

import contextlib
import copy
import os
import signal
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from ..configs import Config
from ..data.codec import decode_batch, depth_storage_units, encode_batch
from ..data.prefetch import device_prefetch
from ..obs.spans import span
from ..parallel import (MeshGroup, all_reduce_grads_, broadcast_module, data_axis,
                        local_shard, use_group, world_of)
from .optim import clip_by_global_norm_, global_norm, make_optimizer, make_schedule
from .tasks import Task


@contextlib.contextmanager
def deterministic_kernels(on: bool = True) -> Iterator[None]:
    """Torch's deterministic mode for the enclosed steps (nothing when not
    `on`), its flags restored after: the ranks of a model axis compute the
    replicated part of a step (everything but the attention's query rows)
    each on its own, so a kernel that adds in a run-dependent order (cuDNN's
    atomic convolution backwards, the bilinear upsample's backward) would
    part their states by a rounding a step. cuBLAS needs its workspace fixed
    for it (CUBLAS_WORKSPACE_CONFIG, set for the steps where unset). New
    tensors are not filled (the mode's default would write every
    `torch.empty`), so the kernels see their buffers as on every other path."""
    if not on:
        yield
        return
    import torch.utils.deterministic as det

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            det.fill_uninitialized_memory, os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        det.fill_uninitialized_memory = prev[2]
        if prev[3] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


@dataclass
class TrainState:
    """The step count, the module (its parameters and BatchNorm statistics)
    and the optimizer (its state). A train step updates all three in place."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer


class Engine:
    def __init__(self, cfg: Config, task: Task, steps_per_epoch: int = 1, group=None):
        self.cfg = cfg
        self.task = task
        self.group = group
        # the batch reductions' ranks, and every rank
        self.data_group, self.world = data_axis(group), world_of(group)
        self.device = task.device
        sequence_parallel = isinstance(group, MeshGroup) and group.axis_size("model") > 1
        if sequence_parallel:
            task.attach_group(group)  # the frame-sharded STFT front end
        # the model ranks' replicated computation, bit-alike on a card
        self._deterministic = sequence_parallel and self.device.type == "cuda"
        if group is not None:
            broadcast_module(task.model, self.world)
        self.schedule = make_schedule(cfg.mode, steps_per_epoch)
        self.steps_per_epoch = steps_per_epoch
        # compact-transport decode scale: the dataset's STORED depth range
        self._depth_units = depth_storage_units(cfg)
        self._encode_units = (None if cfg.mode.compute_dtype == "float64"
                              else self._depth_units)
        self.history: List[Dict[str, object]] = []

    def init_state(self) -> TrainState:
        model = self.task.model
        return TrainState(step=0, model=model, optimizer=make_optimizer(
            self.task.trainable_parameters(), self.cfg.mode))

    # ------------------------------------------------------------------
    def encode(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """The host's half of the transport: the compact codec, except in
        float64 mode."""
        if self._encode_units is None:
            return batch
        return encode_batch(batch, self._encode_units)

    def put_batch(self, batch) -> Dict[str, torch.Tensor]:
        """Host arrays (or tensors) → tensors on the task's device."""
        return {k: torch.as_tensor(np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v)
                .to(self.device, non_blocking=True) for k, v in batch.items()}

    def train_step(self, state: TrainState, batch, epoch: float = 0.0):
        """One optimizer step on `batch`; returns (state, metrics), metrics
        being device tensors: the task's scalar aux and the global gradient
        norm before clipping."""
        if "_valid" in batch:
            raise ValueError("padded batches (_valid mask) are eval-only; train loaders "
                             "must produce full batches (drop_last)")
        dev = self.device
        with span("engine.train_step", dev), deterministic_kernels(self._deterministic):
            with span("engine.decode", dev):
                batch = decode_batch(self.put_batch(batch), self._depth_units)
            opt = state.optimizer
            with span("engine.forward", dev):
                opt.zero_grad(set_to_none=True)
                self.task.begin_step(state.step)
                with use_group(self.group):
                    loss, aux = self.task.loss_fn(batch, float(epoch))
            # the backward too runs in the group: remat recomputes BatchNorm there
            with span("engine.backward", dev), use_group(self.group):
                loss.backward()
            # a frozen part's parameters have no gradient: its zeros add nothing
            # to the norm
            grads = [p.grad for p in state.model.parameters() if p.grad is not None]
            if self.data_group is not None and self.data_group.size > 1:
                all_reduce_grads_(grads, self.data_group)
            with span("engine.optimizer", dev):
                norm = global_norm(grads)
                clip = self.cfg.mode.grad_clip_norm
                if clip and clip > 0:
                    clip_by_global_norm_(grads, norm, clip)
                lr = self.schedule(state.step)
                for group in opt.param_groups:
                    group["lr"] = lr
                opt.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in aux.items()}
        metrics["grad_norm"] = norm
        return state, metrics

    @torch.no_grad()
    def _eval_core(self, batch, epoch: float):
        """(per-sample metrics, decoded device batch, raw prediction) of one
        eval-mode forward. A ragged tail arrives padded with a `_valid` row
        mask: pad rows' metrics are zeroed and the mask is returned, so
        `evaluate` divides by the true count."""
        batch = dict(batch)
        valid = batch.pop("_valid", None)
        if valid is not None:
            valid = torch.as_tensor(valid, device=self.device)
        batch = decode_batch(self.put_batch(batch), self._depth_units)
        # one forward serves the metrics and the criterion (one front end
        # launch an eval batch)
        pred = self.task.predict_raw(batch)
        out = self.task.eval_metrics(batch, pred=pred)
        crit = getattr(self.task, "eval_criterion_loss", None)
        batch_loss = crit(batch, epoch, pred, valid=valid) if crit is not None else None
        if valid is not None:
            valid = valid.to(torch.float32)
            out = {k: v * valid for k, v in out.items()}
            out["_valid"] = valid
        if batch_loss is not None:
            out["_batch_criterion_loss"] = batch_loss
        return out, batch, pred

    def eval_step(self, state: TrainState, batch, epoch: float = 0.0) -> Dict[str, torch.Tensor]:
        """Per-sample metrics of one batch (see `_eval_core`)."""
        return self._eval_core(batch, epoch)[0]

    def eval_step_pred(self, state: TrainState, batch, epoch: float = 0.0):
        """(per-sample metrics, prediction in meters, ground truth in
        meters) of one batch, from one forward."""
        out, dec, pred = self._eval_core(batch, epoch)
        return out, self.task.pred_to_meters(pred), self.task.to_meters(dec["depth"])

    def predict_meters(self, state: TrainState, batch) -> torch.Tensor:
        """The depth prediction in meters of a DECODED device batch."""
        return self.task.predict_meters(batch)

    def local_rows(self, batch):
        """This rank's rows of a GLOBAL eval batch (`parallel.local_shard`
        over the data axis: padded to a multiple of its size with a `_valid`
        mask); the batch itself on one rank."""
        dg = self.data_group
        if dg is None:
            return batch
        return local_shard(batch, dg.size, dg.rank, dg.size)

    def evaluate(self, state: TrainState, batches: Iterable,
                 epoch: float = 0.0) -> Dict[str, float]:
        """Mean per-sample metrics over an eval split (pad rows excluded);
        `criterion_loss` is the equal-weight mean of the per-batch criterion
        where the task defines one (train.py:842). `batches` are global: in
        a group each rank evaluates its rows and the sums are all-reduced;
        the criterion is the global batch's already. Sums accumulate in
        float64, so N ranks' partial sums add up to one rank's."""
        sums: Dict[str, float] = {}
        count = 0.0
        crit_sum, n_batches = 0.0, 0
        with use_group(self.group), deterministic_kernels(self._deterministic):
            for batch in batches:
                out = dict(self.eval_step(state, self.local_rows(batch), epoch))
                valid = out.pop("_valid", None)
                bl = out.pop("_batch_criterion_loss", None)
                if bl is not None:
                    crit_sum += float(bl)
                    n_batches += 1
                if valid is not None:
                    count += float(valid.sum())
                else:
                    count += int(next(iter(out.values())).shape[0])
                for k, v in out.items():
                    sums[k] = sums.get(k, 0.0) + float(v.sum(dtype=torch.float64))
        if self.group is not None:
            keys = sorted(sums)
            total = torch.tensor([sums[k] for k in keys] + [count], dtype=torch.float64,
                                 device=self.device)
            total = self.data_group.all_reduce_(total).tolist()
            sums, count = dict(zip(keys, total[:-1])), total[-1]
        if count == 0:
            return {}
        result = {k: v / count for k, v in sums.items()}
        if n_batches:
            result["criterion_loss"] = crit_sum / n_batches
        return result

    # ------------------------------------------------------------------
    @staticmethod
    def _snapshot(state: TrainState):
        """(step, model state_dict, optimizer state_dict), cloned: the
        parameters and AdamW's moments change in place in the next step."""
        return (state.step,
                {k: v.detach().clone() for k, v in state.model.state_dict().items()},
                copy.deepcopy(state.optimizer.state_dict()))

    @staticmethod
    def _restore_snapshot(state: TrainState, snap) -> TrainState:
        step, model_sd, opt_sd = snap
        state.model.load_state_dict(model_sd)
        state.optimizer.load_state_dict(opt_sd)
        state.step = step
        return state

    def _detectors(self, state, epoch: int, first, vis_callback) -> None:
        """The negative and stuck-at-zero prediction warnings, and the
        visualization callback, on the first validation batch: one more
        eval-mode forward (one more front end launch) each validation. In a
        group every rank predicts its rows and rank 0 gathers the whole
        batch's prediction, as a JAX mesh's detectors read it, and runs the
        checks and the callback alone."""
        rows = int(next(iter(first.values())).shape[0])
        local = self.local_rows({k: v for k, v in first.items() if k != "_valid"})
        local.pop("_valid", None)
        with use_group(self.group), deterministic_kernels(self._deterministic):
            dec = decode_batch(self.put_batch(local), self._depth_units)
            pred = self.predict_meters(state, dec).detach().float()
        if self.group is not None:
            pred = self.data_group.all_gather_rows(pred)[:rows]
            if not self.world.is_main:
                return
        pred = pred.cpu().numpy()
        if (pred < 0).any():
            print(f"WARNING epoch {epoch}: negative depth predictions (min={pred.min():.4f})")
        if np.abs(pred).max() < 1e-6:
            print(f"WARNING epoch {epoch}: predictions stuck at zero")
        if vis_callback is not None:
            vis_callback(epoch, first, pred)

    def fit(self, state: TrainState, train_batches: Callable[[], Iterable],
            val_batches: Optional[Callable[[], Iterable]] = None,
            epochs: Optional[int] = None, start_epoch: int = 1,
            log: Optional[Callable[[Dict[str, object]], None]] = None,
            on_step: Optional[Callable[[TrainState, Dict[str, torch.Tensor]], None]] = None,
            ckpt_manager=None, best_tracker=None, logger=None,
            holdout_batches: Optional[Dict[str, Callable[[], Iterable]]] = None,
            vis_callback=None, profiler=None) -> TrainState:
        """The epoch loop. Each epoch's record (appended to `self.history`
        and passed to `log`) holds the per-epoch means of the scalar aux, the
        last step's grad_norm, the lr the epoch started at, its time and
        pairs_per_sec, and every validation_iter epochs the validation means
        (`val`) and each holdout loader's (`holdout`). A `logger`
        (obs.MetricLogger) receives the JAX fit's keys: train/loss,
        train/<component>, train/grad_norm, train/lr, train/epoch_time,
        train/pairs_per_sec_per_chip, val/*, holdout/<name>/*.
        `on_step(state, metrics)` runs after every step, while the step's
        gradients are still on the parameters. train_batches, val_batches
        and each holdout loader are zero-argument callables that return a
        fresh iterator of host batches (or of the device cache's): in a
        group, this rank's rows of each train batch and the global eval
        batches.

        With a `ckpt_manager`, the state is saved every saving_checkpoints
        epochs (train.py:1005-1021), when `best_tracker.update` reports a new
        best validation metric (then marked best, train.py:873-913), and at
        the final epoch, which the reference's cadence may miss. A resumed
        run passes the epoch after the restored one as `start_epoch`.

        Preemption: with a manager, on the main thread, a SIGTERM handler is
        installed for the loop. It stops the loop at the next step boundary,
        discards the partial epoch, saves the last completed epoch's state
        (kept as a clone taken at each epoch's end, since the parameters and
        the optimizer's state change in place) and returns that state, with
        `self.preempted` set; --resume continues from there. In a group the
        ranks agree at every step boundary whether any of them was
        signalled (an all-reduce of the flag), so all stop at the same step;
        `log` and `logger` run on rank 0 alone."""
        mode = self.cfg.mode
        epochs = epochs or mode.epochs
        self.preempted = False
        group = self.world
        if group is not None and not group.is_main:
            log = logger = None
        world = 1 if group is None else group.size
        data_ranks = 1 if group is None else self.data_group.size

        def save(epoch, metrics=None):
            aux = getattr(self.task, "checkpoint_aux", lambda: None)()
            ckpt_manager.save(epoch, state, aux=aux, metrics=metrics)

        preempt = {"sig": None}

        def stopping() -> bool:
            """Whether this rank, or in a group any rank, was signalled."""
            if group is None:
                return preempt["sig"] is not None
            if group.any(preempt["sig"] is not None):
                preempt["sig"] = preempt["sig"] or signal.SIGTERM
                return True
            return False

        installed, old_handler = False, None
        if ckpt_manager is not None and getattr(mode, "save_on_preempt", True):
            def on_term(signum, frame):
                preempt["sig"] = signum
                print(f"[engine] caught signal {signum}: stopping at the next step "
                      "boundary to checkpoint the last completed epoch", flush=True)

            try:
                old_handler = signal.signal(signal.SIGTERM, on_term)
                installed = True
            except ValueError:  # not the main thread
                pass
        completed_epoch = start_epoch - 1
        completed = self._snapshot(state) if installed else None
        profile_epoch = min(start_epoch + 1, epochs) if profiler is not None else None
        try:
            for epoch in range(start_epoch, epochs + 1):
                if stopping():
                    break
                if epoch == profile_epoch:
                    profiler.start(f"epoch_{epoch}")
                t0 = time.perf_counter()
                n_samples = n_steps = 0
                sums: Dict[str, torch.Tensor] = {}
                last: Dict[str, torch.Tensor] = {}
                for batch in device_prefetch(train_batches(), self.device,
                                             encode_units=self._encode_units):
                    if stopping():
                        break
                    n_samples += int(next(iter(batch.values())).shape[0]) * data_ranks
                    state, last = self.train_step(state, batch, epoch=float(epoch - 1))
                    if on_step is not None:
                        on_step(state, last)
                    for k, v in last.items():
                        if k != "grad_norm" and v.dim() == 0:
                            sums[k] = sums[k] + v if k in sums else v
                    n_steps += 1
                if stopping():
                    break  # the partial epoch is discarded
                # the one host readback of the epoch, and its time's sync point
                record: Dict[str, object] = {"epoch": epoch}
                record.update({k: float(v) / n_steps for k, v in sums.items()})
                if "grad_norm" in last:
                    record["grad_norm"] = float(last["grad_norm"])
                dt = time.perf_counter() - t0
                if epoch == profile_epoch:
                    profiler.stop()
                    print(f"profiler trace for epoch {epoch}: {profiler.path}", flush=True)
                record.update(lr=self.schedule((epoch - 1) * self.steps_per_epoch),
                              steps=n_steps, samples=n_samples, epoch_time=dt,
                              pairs_per_sec=n_samples / max(dt, 1e-9))
                if logger is not None:
                    logger.log({
                        "train/loss": record.get("loss"),
                        **{f"train/{k}": v for k, v in record.items()
                           if k in sums and k != "loss"},
                        "train/grad_norm": record.get("grad_norm"),
                        "train/lr": record["lr"],
                        "train/epoch_time": dt,
                        "train/pairs_per_sec_per_chip": record["pairs_per_sec"] / world,
                    }, step=epoch)
                if (val_batches is not None and mode.validation
                        and epoch % mode.validation_iter == 0):
                    val = self.evaluate(state, val_batches(), epoch=float(epoch - 1))
                    record["val"] = val
                    if logger is not None and val:
                        logger.log({f"val/{k}": v for k, v in val.items()}, step=epoch)
                    # in a group every rank takes part (rank 0 alone has the
                    # logger)
                    if group is not None or vis_callback is not None or logger is not None:
                        first = next(iter(val_batches()), None)
                        if first is not None:
                            self._detectors(state, epoch, first, vis_callback)
                    if best_tracker is not None and val and best_tracker.update(epoch, val):
                        if ckpt_manager is not None:
                            save(epoch, val)
                            ckpt_manager.mark_best(epoch, best_tracker.metric,
                                                   best_tracker.best_value)
                    if holdout_batches:
                        record["holdout"] = {}
                    for name, batches in (holdout_batches or {}).items():
                        h = self.evaluate(state, batches(), epoch=float(epoch - 1))
                        record["holdout"][name] = h
                        if logger is not None and h:
                            logger.log({f"holdout/{name}/{k}": v for k, v in h.items()},
                                       step=epoch)
                if ckpt_manager is not None and epoch % mode.saving_checkpoints == 0:
                    save(epoch)
                completed_epoch = epoch
                if installed:
                    completed = self._snapshot(state)
                self.history.append(record)
                if log is not None:
                    log(record)
        finally:
            if profiler is not None:
                profiler.stop()  # a preemption inside the profiled epoch
            if installed:
                signal.signal(signal.SIGTERM, old_handler or signal.SIG_DFL)
        if stopping():
            self.preempted = True
            state = self._restore_snapshot(state, completed)
            if completed_epoch >= start_epoch:
                save(completed_epoch)
                print(f"[engine] preemption checkpoint saved at epoch {completed_epoch}; "
                      "resume with --resume", flush=True)
            else:
                print("[engine] preempted before the first epoch completed; "
                      "nothing new to checkpoint", flush=True)
            return state
        if ckpt_manager is not None and epochs >= start_epoch:
            save(epochs)  # idempotent where the cadence or a best save wrote it
        return state
