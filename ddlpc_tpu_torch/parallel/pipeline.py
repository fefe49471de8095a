"""GPipe pipeline stages — the port's copy of ``ddlpc_tpu/parallel/pipeline.py``.

The U-Net is cut into ``S`` contiguous stages of its block list
(``models/unet.UNet.pipeline_block_names``), balanced by parameter bytes
(:func:`build_stage_plan`, the stage rule table of ``partition.py``), and
driven by the JAX package's two-phase GPipe round-robin over ``M``
micro-batches.

The driver is MPMD across processes: the world is a ``pipe × data`` grid
(``mesh.init_grid``; ``pipe`` outermost), and rank ``(s, d)`` holds stage
``s``'s parameters for data replica ``d`` — its own modules of the
network on its device, re-homed into flat buffers (``FlatParams``), the
rest of the network staying a host copy it never runs.  Carries (the
stage's output ``{'x', 'skips'[, 'image']}``) and their cotangents cross
stages by point-to-point sends between ``(s, d)`` and ``(s ± 1, d)``:
posted without waiting (:class:`_Wire`, through ``mesh.isend`` and
``mesh.recv``), so that no schedule order can deadlock, and drained at
the end of the step.  Under the collective census each carry tensor sent
is a ``send`` row, and the step tags its stretches as the JAX package's
stage programs (:func:`stage_program_names`: ``stage<s>_fwd``,
``stage<s>_bwd`` or the last stage's ``stage<S-1>_loss_bwd``,
``stage<s>_update``; the closing metrics sum ``tail``), which
``analysis/program.py`` holds to ``stage-boundary`` and the update's
contracts.

The schedule (:meth:`PipelineTrainStep.step`) is JAX's: forward cycles
run stage ``s`` on micro-batch ``t − s`` for the stages before the last,
stashing only each micro-batch's input carry; the last stage folds its
forward into the loss and the backward; a backward recomputes its
segment from the stashed carry (stage-granular remat).  JAX stashes the
BatchNorm statistics each forward read as well; the port's train-mode
BatchNorm reads only its batch, and the recompute runs under
``layers.recomputing`` so that it does not advance the running
statistics a second time.  Each rank runs the slots of its own stage in
that order; ``last_schedule`` counts every stage's executed slots as
JAX's does.

The stage update is the unstaged step's tail (``train_step.sync_and_update``)
over the stage's data group: the codec's fenced wire and the ``off`` /
``zero1`` / ``zero2`` ladder, then the BatchNorm statistics averaged over
the replicas.  Where JAX refuses, the port refuses: a space axis under
pipe, ``zero3``, and ``zero2`` with a codec the scatter cannot reproduce.
``pipeline_stages = 1`` delegates to ``train_step.make_train_step``, bit
for bit.

:meth:`PipelineTrainStep.canonical` gathers the stage states into one
unsharded ``TrainState`` on the CPU (every rank must call it), which the
port's checkpoints write; :meth:`PipelineTrainStep.init_state` places
such a state (or a checkpoint's) into the stages.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ddlpc_tpu_torch.config import CompressionConfig
from ddlpc_tpu_torch.convert import flax_param_path, gather_canonical, load_canonical
from ddlpc_tpu_torch.models.layers import recomputing
from ddlpc_tpu_torch.parallel import mesh, partition
from ddlpc_tpu_torch.parallel.grad_sync import validate_scatter_compression
from ddlpc_tpu_torch.parallel.shard_update import normalize_shard_update
from ddlpc_tpu_torch.parallel.train_step import (
    TrainState,
    create_train_state,
    loss_from_logits,
    make_train_step,
    mean_batch_stats,
    sync_and_update,
)
from ddlpc_tpu_torch.train.optim import Optimizer


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe's fill/drain bubble a phase: ``(S−1)/(M+S−1)``."""
    s, m = int(n_stages), int(n_microbatches)
    if s < 1 or m < 1:
        raise ValueError(f"need S >= 1 and M >= 1, got S={s} M={m}")
    return (s - 1) / (m + s - 1)


def param_tree(model: nn.Module) -> dict:
    """The model's parameters as a nested dict by flax path (the leaves
    the port's tensors: only their shapes and bytes matter to a plan)."""
    tree: dict = {}
    for name, p in model.named_parameters():
        path = flax_param_path(name, p.dim())
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = p
    return tree


def _subtree(tree: dict, path: str):
    node = tree
    for seg in path.split("/"):
        if not isinstance(node, dict) or seg not in node:
            return None
        node = node[seg]
    return node


def _tree_bytes(tree) -> int:
    return sum(partition.leaf_bytes(leaf) for _, leaf in partition.leaves_with_path(tree))


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """The cut: each block's stage, and the rule table over module paths
    that every split reads."""

    block_names: Tuple[str, ...]
    assignment: Tuple[int, ...]
    rules: Tuple[partition.StageRule, ...]
    n_stages: int

    def stage_blocks(self, s: int) -> Tuple[str, ...]:
        return tuple(b for b, a in zip(self.block_names, self.assignment) if a == s)

    def stage_of(self, name: str) -> int:
        """The stage of a torch parameter or buffer name."""
        return partition.match_stage_rules(self.rules, name.replace(".", "/"))

    def split(self, tree: dict, prefix: str = "") -> List[dict]:
        return partition.split_tree_by_stage(self.rules, tree, self.n_stages, prefix)

    @staticmethod
    def merge(stage_trees: Sequence[dict]) -> dict:
        return partition.merge_stage_trees(stage_trees)


def build_stage_plan(model: nn.Module, params: dict, n_stages: int) -> StagePlan:
    """Cut ``model``'s blocks into ``n_stages`` contiguous groups balanced
    by the bytes of ``params`` (a nested dict by flax path:
    :func:`param_tree`, or the JAX package's own params)."""
    if not hasattr(model, "pipeline_block_names"):
        raise ValueError(
            f"{type(model).__name__} does not declare pipeline blocks "
            f"(pipeline_block_names/pipeline_block_modules) — staged "
            f"execution currently covers the U-Net family; see ROADMAP"
        )
    blocks = tuple(model.pipeline_block_names())
    modules = model.pipeline_block_modules()
    block_bytes = []
    for b in blocks:
        block_bytes.append(sum(_tree_bytes(sub) for m in modules[b]
                               if (sub := _subtree(params, m)) is not None))
    assignment = partition.balanced_stage_assignment(block_bytes, n_stages)
    mod_names, mod_stage = [], []
    for b, a in zip(blocks, assignment):
        for m in modules[b]:
            mod_names.append(m)
            mod_stage.append(a)
    rules = partition.stage_rules_for_blocks(mod_names, mod_stage)
    return StagePlan(blocks, tuple(assignment), rules, n_stages)


def stage_param_bytes(plan: StagePlan, params: dict) -> List[int]:
    """Bytes of each stage's parameters under ``plan``."""
    return [_tree_bytes(t) for t in plan.split(params)]


def split_opt_state(opt: dict, plan: StagePlan) -> List[dict]:
    """An optimizer state as ``convert.gather_canonical`` gives it (the
    count, each moment by parameter name) cut into the stages' own: each
    moment's leaves by stage, the count and the optax layout in every
    stage (they advance in lockstep)."""
    outs = [{k: v for k, v in opt.items() if k not in _moments(opt)}
            for _ in range(plan.n_stages)]
    for key in _moments(opt):
        for out in outs:
            out[key] = {}
        for name, v in opt[key].items():
            outs[plan.stage_of(name)][key][name] = v
    return outs


def merge_opt_state(stage_opts: Sequence[dict]) -> dict:
    """Inverse of :func:`split_opt_state`: the moments united, the count
    and layout stage 0's."""
    out = {k: v for k, v in stage_opts[0].items() if k not in _moments(stage_opts[0])}
    for key in _moments(stage_opts[0]):
        out[key] = {}
        for o in stage_opts:
            clash = set(out[key]) & set(o[key])
            if clash:
                raise ValueError(f"opt_state leaves {sorted(clash)} in two stages")
            out[key].update(o[key])
    return out


def _moments(opt: dict) -> List[str]:
    return [k for k in ("mu", "nu", "trace") if k in opt]


# ---------------------------------------------------------------------------
# the stage's modules


def stage_view(network: nn.Module, paths: Sequence[str]) -> nn.Module:
    """A module whose children are ``network``'s modules at ``paths``
    (``/``-joined), under the same names: its ``named_parameters`` and
    ``state_dict`` use the network's torch names.  The network itself is
    kept, unregistered, as ``view.network`` (the staged forward runs on
    it)."""
    root = nn.Module()
    for path in paths:
        parts = path.split("/")
        node, src = root, network
        for part in parts[:-1]:
            src = getattr(src, part)
            if part not in node._modules:
                node.add_module(part, nn.Module())
            node = node._modules[part]
        if hasattr(src, parts[-1]):  # absent: a parameterless cut point
            node.add_module(parts[-1], getattr(src, parts[-1]))
    object.__setattr__(root, "network", network)
    return root


@dataclasses.dataclass
class PipelineState:
    """This rank's stage: one ``TrainState`` over its stage's modules
    (``stages[0]``; its ``model`` a :func:`stage_view`).  Every rank holds
    only its own stage."""

    stages: List[TrainState]

    @property
    def step(self) -> int:
        return self.stages[0].step


# ---------------------------------------------------------------------------
# the wire between stages

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
_HEADER = 64


def _flatten_carry(carry: dict) -> List[torch.Tensor]:
    return [carry["x"], *carry["skips"]] + ([carry["image"]] if "image" in carry else [])


def _unflatten_carry(ts: List[torch.Tensor], n_skips: int, has_image: bool) -> dict:
    out = {"x": ts[0], "skips": tuple(ts[1 : 1 + n_skips])}
    if has_image:
        out["image"] = ts[1 + n_skips]
    return out


class _Wire:
    """Point-to-point transfers between stages, through ``mesh.isend`` and
    ``mesh.recv``: sends are posted and not waited for until :meth:`drain`
    (so no order of the schedule can deadlock); a receive waits.  gloo
    takes CPU tensors only, so a card's tensors go through host copies
    there; bfloat16 travels as its int16 bits.  Under a census every
    carry tensor sent is one ``send`` row, every header one
    ``send_header`` row."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host = dist.get_backend() == "gloo" and device.type == "cuda"
        self.pending: list = []
        self._header_device = torch.device("cpu") if self.host else device

    def send(self, tensors: Sequence[torch.Tensor], dst: int) -> None:
        for t in tensors:
            self.pending.append(mesh.isend(t, dst, self.host))

    def recv(self, like: Sequence[Tuple[tuple, torch.dtype]], src: int) -> List[torch.Tensor]:
        # A new tensor each: a leaf that may require grad.
        return [mesh.recv(shape, dtype, src, self.device, self.host) for shape, dtype in like]

    def send_carry(self, carry: dict, dst: int) -> None:
        ts = _flatten_carry(carry)
        head = [len(carry["skips"]), int("image" in carry), len(ts)]
        for t in ts:
            head += [_DTYPES.index(t.dtype), t.dim(), *t.shape]
        if len(head) > _HEADER:
            raise ValueError(f"a carry of {len(ts)} tensors does not fit the header")
        header = torch.zeros(_HEADER, dtype=torch.int64, device=self._header_device)
        header[: len(head)] = torch.tensor(head)
        self.pending.append(mesh.isend(header, dst, op="send_header"))
        self.send(ts, dst)

    def recv_carry(self, src: int) -> dict:
        h = mesh.recv((_HEADER,), torch.int64, src, self._header_device).tolist()
        n_skips, has_image, n = h[0], h[1], h[2]
        like, i = [], 3
        for _ in range(n):
            dt, nd = h[i], h[i + 1]
            like.append((tuple(h[i + 2 : i + 2 + nd]), _DTYPES[dt]))
            i += 2 + nd
        return _unflatten_carry(self.recv(like, src), n_skips, bool(has_image))

    def drain(self) -> None:
        for work, _ in self.pending:
            work.wait()
        self.pending = []


# ---------------------------------------------------------------------------
# the driver


class PipelineTrainStep:
    """The MPMD pipeline train step of this rank (see the module
    docstring).  ``model`` is the whole network (its weights are not
    read: :meth:`init_state` places a state's); ``device`` this rank's.

    ``init_state(full)`` places an unsharded ``TrainState`` (or one
    :meth:`canonical` returned) into this rank's stage; ``step(pstate,
    images [M,B,H,W,C], labels [M,B,H,W])``, the same global
    micro-batches on every rank (B the global micro-batch, this replica
    taking its ``B/N`` columns), runs one optimizer step and returns
    ``{loss, pixel_acc, grad_norm}`` as floats; ``canonical(pstate)``
    gathers the stages back.  ``last_schedule`` is the executed and idle
    ``(stage × cycle)`` slots of the step's round-robin and their ratio."""

    def __init__(
        self,
        model: nn.Module,
        tx: Optimizer,
        compression: CompressionConfig,
        n_microbatches: int,
        shard_update: str = "off",
        seed: int = 0,
        device: Optional[torch.device] = None,
    ):
        self.tx, self.compression, self.seed = tx, compression, seed
        self.device = torch.device(device or "cpu")
        grid = mesh.grid()
        self.n_stages = grid.pipe
        self.n_microbatches = max(int(n_microbatches), 1)
        self._n_data = grid.data
        self._template = copy.deepcopy(model).cpu()
        level = normalize_shard_update(shard_update)
        self.last_schedule: Dict[str, float] = {}
        self.stash_bytes = 0
        if self.n_stages <= 1:
            self._level = "off" if grid.data <= 1 else level
            self._mono = make_train_step(tx, compression, grid.data, seed=seed, level=self._level)
            return
        if grid.space > 1:
            raise ValueError(
                "pipeline stages × space sharding of the full model is not "
                "wired yet: segment shard_map programs do not emit the "
                "per-conv halo exchanges the GSPMD path gets for free "
                "(parallel/halo.py composes with staged execution at the "
                "carry level — tests/test_pipeline.py — full-model wiring "
                "is a ROADMAP follow-on)"
            )
        if level == "zero3":
            raise ValueError(
                "shard_update='zero3' does not compose with pipeline "
                "stages yet: stage residency already divides params by S; "
                "per-leaf gather-on-demand inside staged segments is a "
                "ROADMAP follow-on (use off/zero1/zero2 within stages)"
            )
        if level == "zero2":
            validate_scatter_compression(compression)
        self._level = "off" if grid.data <= 1 else level
        self.plan = build_stage_plan(self._template, param_tree(self._template), self.n_stages)
        self.stage, self.replica = grid.coords[0], grid.coords[1]
        self.blocks = self.plan.stage_blocks(self.stage)
        modules = self._template.pipeline_block_modules()
        self._stage_paths = [m for b in self.blocks for m in modules[b]]
        self._peer = {d: grid.global_rank(self.stage + d, self.replica, 0)
                      for d in (-1, 1) if 0 <= self.stage + d < self.n_stages}

    # -- canonical <-> placed -------------------------------------------------

    def init_state(self, full: TrainState) -> PipelineState:
        """This rank's stage of an unsharded state (every rank passes the
        same; under pipe = 1 the state itself, already in this replica's
        layout, is the stage)."""
        if self.n_stages <= 1:
            return PipelineState([full])
        sd, opt = gather_canonical(full)
        network = copy.deepcopy(self._template)
        view = stage_view(network, self._stage_paths).to(self.device)
        state = create_train_state(view, self.tx, self._n_data, self._level)
        mine = {k: v for k, v in sd.items() if self.plan.stage_of(k) == self.stage}
        load_canonical(state, mine, split_opt_state(opt, self.plan)[self.stage])
        state.step = full.step
        return PipelineState([state])

    def canonical(self, pstate: PipelineState) -> TrainState:
        """The unsharded state on the CPU: every stage's parameters,
        statistics and moments in one ``TrainState`` at ``off`` (every
        rank must call it, and gets it)."""
        state = pstate.stages[0]
        if self.n_stages <= 1:
            sd, opt = gather_canonical(state)
            return self._assemble([(sd, opt, state.step)])
        sd, opt = gather_canonical(state)
        mine = None
        if self.replica == 0:
            mine = ({k: v.numpy() for k, v in sd.items()},
                    {k: ({n: t.numpy() for n, t in v.items()} if isinstance(v, dict) else v)
                     for k, v in opt.items()}, state.step)
        parts: list = [None] * mesh.world_size()
        dist.all_gather_object(parts, mine)
        stages = [p for p in parts if p is not None]
        tensor = lambda d: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}  # noqa: E731
        return self._assemble([(tensor(s), {k: tensor(v) if isinstance(v, dict) else v
                                            for k, v in o.items()}, st)
                               for s, o, st in stages])

    def _assemble(self, stages) -> TrainState:
        sd = {}
        for s, _, _ in stages:
            sd.update(s)
        opt = merge_opt_state([o for _, o, _ in stages])
        model = copy.deepcopy(self._template)
        full = create_train_state(model, self.tx, 1, "off")
        load_canonical(full, {k: v.cpu() for k, v in sd.items()}, opt)
        full.step = stages[0][2]
        return full

    def carry_shapes(self, image_shape: Sequence[int]) -> List[List[Tuple[tuple, torch.dtype]]]:
        """Each stage boundary's carry for one micro-batch of
        ``image_shape`` ``[B,H,W,C]`` (``S − 1`` lists of ``(shape,
        dtype)``), traced on the meta device: what one send moves, and
        what a stage's input stash holds ``M`` of."""
        if self.n_stages <= 1:
            return []
        network = copy.deepcopy(self._template).to("meta").train()
        x = torch.empty(tuple(image_shape), device="meta")
        carry, out = None, []
        with torch.no_grad():
            for s in range(self.n_stages - 1):
                carry = network(x if carry is None else None, self.plan.stage_blocks(s), carry)
                out.append([(tuple(t.shape), t.dtype) for t in _flatten_carry(carry)])
        return out

    # -- the step ---------------------------------------------------------------

    def _columns(self, a) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        b = t.shape[1] // self._n_data
        r = mesh.replica_index()
        return t[:, r * b : (r + 1) * b].to(self.device)

    def step(self, pstate: PipelineState, images, labels) -> Tuple[PipelineState, Dict[str, float]]:
        S, M = self.n_stages, self.n_microbatches
        if images.shape[0] != M:
            raise ValueError(f"images leading dim {images.shape[0]} != n_microbatches={M}")
        images, labels = self._columns(images), self._columns(labels).long()
        state = pstate.stages[0]
        if S <= 1:
            self.last_schedule = {"executed_slots": M, "idle_slots": 0, "measured_bubble": 0.0}
            metrics = self._mono(state, images, labels)
            return pstate, {k: float(v) for k, v in metrics.items()}
        s, last = self.stage, S - 1
        network = state.model.network
        network.train()
        wire = _Wire(self.device)
        flat = state.params
        flat.grad.zero_()
        layout = getattr(network, "train_head_layout", "fullres")
        stash: List[Optional[dict]] = [None] * M
        executed = 0
        losses, accs = [], []

        def forward(m: int, carry: Optional[dict]):
            return network(images[m] if carry is None else None, self.blocks, carry)

        # Forward phase: cycle t runs stage s on micro-batch t − s, for
        # every stage but the last (which folds its forward into the loss);
        # a stage's input carries arrive in the cycle after their sender's
        # and stay stashed until their backward.
        self.stash_bytes = held = 0
        # The census' segments are JAX's stage programs
        # (stage_program_names): the last stage folds its forward into its
        # loss and backward, so its forward phase (receives only) is that.
        bwd_name = stage_program_names(s, S)[-2]
        with mesh.census_segment(f"stage{s}_fwd" if s < last else bwd_name):
            for t in range(M + S - 2):
                m = t - s
                if s > 0 and 0 <= m + 1 < M:
                    stash[m + 1] = wire.recv_carry(self._peer[-1])
                    held += _carry_bytes(stash[m + 1])
                    self.stash_bytes = max(self.stash_bytes, held)
                if s == last or not 0 <= m < M:
                    continue
                with torch.no_grad():
                    out = forward(m, stash[m])
                wire.send_carry(out, self._peer[1])
                executed += 1

        # Backward phase: stage s at cycle t runs micro-batch t − (S−1−s).
        with mesh.census_segment(bwd_name):
            for t in range(M + S - 1):
                m = t - (last - s)
                if not 0 <= m < M:
                    continue
                cin, stash[m] = stash[m], None
                if s == last:
                    leaves = _flatten_carry(cin)
                    for x in leaves:
                        x.requires_grad_(True)
                    loss, acc = loss_from_logits(forward(m, cin), labels[m], layout)
                    loss.backward()
                    losses.append(loss.detach())
                    accs.append(acc.detach())
                else:
                    leaves = [] if cin is None else _flatten_carry(cin)
                    for x in leaves:
                        x.requires_grad_(True)
                    with recomputing():
                        out = _flatten_carry(forward(m, cin))
                    grads = wire.recv([(tuple(x.shape), x.dtype) for x in out], self._peer[1])
                    pairs = [(o, g) for o, g in zip(out, grads) if o.requires_grad]
                    torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
                if s > 0:
                    wire.send([x.grad if x.grad is not None else torch.zeros_like(x)
                               for x in leaves], self._peer[-1])
                executed += 1
            wire.drain()

        flat.grad.div_(M)
        # The stage update: the unstaged step's sync, update and publish
        # over this stage's data group, then its statistics' mean.
        with mesh.census_segment(f"stage{s}_update"):
            sq = sync_and_update(state, self.tx, self.compression, self._n_data, self.seed)
            mean_batch_stats(state.model, self._n_data)
        if sq is None:
            sq = flat.grad.square().sum() if self.replica == 0 else flat.grad.new_zeros(())
        on_last = s == last
        vec = torch.stack([
            torch.stack(losses).mean() if on_last else flat.grad.new_zeros(()),
            torch.stack(accs).mean() if on_last else flat.grad.new_zeros(()),
            sq.to(flat.grad.dtype),
            flat.grad.new_tensor(float(executed if self.replica == 0 else 0)),
        ])
        with mesh.census_segment("tail"):  # no stage program reads it
            mesh.all_reduce_(vec, "sum", "world")
        vec = vec.tolist()
        slots = (S - 1) * (M + S - 2) + S * (M + S - 1)
        done = int(round(vec[3]))
        self.last_schedule = {
            "executed_slots": done,
            "idle_slots": slots - done,
            "measured_bubble": round((slots - done) / slots, 4),
        }
        return pstate, {
            "loss": vec[0] / self._n_data,
            "pixel_acc": vec[1] / self._n_data,
            "grad_norm": float(np.sqrt(vec[2])),
        }


def stage_program_names(stage: int, n_stages: int) -> Tuple[str, ...]:
    """The programs stage ``stage`` of ``n_stages`` runs in a step, by the
    JAX package's names (``ddlpc_tpu/analysis/program.py``
    ``_program_table``): its forward, its backward (the last stage's
    ``loss_bwd``, forward and loss folded in) and its update."""
    if stage == n_stages - 1:
        return (f"stage{stage}_loss_bwd", f"stage{stage}_update")
    return (f"stage{stage}_fwd", f"stage{stage}_bwd", f"stage{stage}_update")


def _carry_bytes(carry: dict) -> int:
    return sum(t.numel() * t.element_size() for t in _flatten_carry(carry))


def make_pipeline_train_step(
    model: nn.Module,
    tx: Optimizer,
    compression: CompressionConfig,
    n_microbatches: int,
    shard_update: str = "off",
    seed: int = 0,
    device: Optional[torch.device] = None,
) -> PipelineTrainStep:
    """The pipeline driver of this rank on the process grid
    (``mesh.init_grid(pipe, data, 1)``): staged when the grid's ``pipe``
    axis is above 1.  See :class:`PipelineTrainStep`."""
    return PipelineTrainStep(model, tx, compression, n_microbatches,
                             shard_update=shard_update, seed=seed, device=device)
