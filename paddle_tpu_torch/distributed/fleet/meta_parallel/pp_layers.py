"""Pipeline layer descriptions and their segmentation.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/pp_layers.py``
(Paddle's ``pp_layers.py``: ``LayerDesc``, ``SharedLayerDesc``,
``SegmentLayers``, ``PipelineLayer``): a layer list cut into stages,
uniformly or at named layers, into ``num_stages * vpp`` chunks for the
interleaved schedule (chunk ``c`` on stage ``c % num_stages``), with
weights tied across stages by ``SharedLayerDesc`` and per-segment
recompute.

Where it runs:

- With no hybrid group of ``num_stages`` pipeline ranks (``fleet.init``
  with that ``pp_degree`` over that many processes), the process builds
  every layer and holds every stage, as the reference's single
  controller does; ``forward`` runs the whole list.
- Over a pipeline group each rank builds only the layers of its stage's
  chunks (``stage_layers(pp_rank)``; ``run_function`` holds ``None`` for
  the others), under their global indices, so its ``state_dict`` is its
  share of the whole model's. A ``SharedLayerDesc`` key held by several
  stages is built on each of them, broadcast at construction from the
  first stage that holds it, and its gradients are summed over those
  stages after each backward (``allreduce_shared_weight_gradients``,
  which ``PipelineParallel`` calls), so the tied weights stay one.
"""
from __future__ import annotations

import re
from typing import Any, List

import torch

__all__ = ["LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineLayer"]


class LayerDesc:
    """Deferred construction of ``layer_func(*inputs, **kwargs)``, a
    ``torch.nn.Module`` class."""

    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs
        if not issubclass(layer_func, torch.nn.Module):
            raise TypeError("The input of LayerDesc should be Layer")

    def build_layer(self) -> torch.nn.Module:
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_func.__name__})"


class SharedLayerDesc(LayerDesc):
    """A layer whose parameters every occurrence of ``key`` shares (tied
    input and output embeddings); ``forward_func(layer, x)``, when given,
    replaces the layer's own forward at an occurrence."""

    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    """Splits ``len(layers_desc)`` layers into ``num_parts`` segments,
    uniformly or at the layers whose class name matches
    ``"layer:<regex>"``: the boundaries as a list of ``num_parts + 1``
    indices."""

    def __init__(self, layers_desc, num_parts, method="uniform"):
        self._layers_desc = layers_desc
        self.method = method
        self.num_parts = num_parts
        self.num_items = len(layers_desc)
        if self.num_items < self.num_parts:
            raise ValueError(
                "layer number should be greater than number of segments")

    def do_segment(self) -> List[int]:
        if self.method == "uniform":
            return self.uniform(self.num_items, self.num_parts)
        if self.method.startswith("layer:"):
            cls_name = self.method.split(":")[1]
            weights = [0] * len(self._layers_desc)
            for i, d in enumerate(self._layers_desc):
                fn = d.layer_func if isinstance(d, LayerDesc) else type(d)
                name = getattr(fn, "__name__", str(fn))
                if re.search(cls_name, name):
                    weights[i] = 1
            total = sum(weights)
            if total < self.num_parts:
                raise ValueError(
                    f"only {total} layers match '{cls_name}', need >= "
                    f"{self.num_parts}")
            # the matching layers spread evenly; a boundary sits before a
            # matching layer
            result = [0] * (self.num_parts + 1)
            memory_counter, part = 0, 1
            for i, w in enumerate(weights):
                if memory_counter == total // self.num_parts \
                        and part < self.num_parts:
                    result[part] = i
                    part += 1
                    memory_counter = 0
                memory_counter += w
            result[self.num_parts] = len(weights)
            return result
        raise ValueError(f"method {self.method} not supported")

    @staticmethod
    def uniform(num_items: int, num_parts: int) -> List[int]:
        result = [0] * (num_parts + 1)
        part_size = num_items // num_parts
        extra = num_items % num_parts
        for i in range(1, num_parts + 1):
            result[i] = result[i - 1] + part_size + (1 if i <= extra else 0)
        return result


def _pipeline_group(num_stages):
    """The hybrid group when it has ``num_stages`` pipeline ranks over
    processes, else None."""
    from ..topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    if hcg is None or num_stages <= 1 \
            or hcg.get_pipe_parallel_world_size() != num_stages \
            or hcg.get_pipe_parallel_group().process_group is None:
        return None
    return hcg


class PipelineLayer(torch.nn.Module):
    """The layer list and its stages (module docstring)."""

    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None):
        super().__init__()
        self._layers_desc = list(layers)
        self._loss_fn = loss_fn
        self._topo = topology
        self._recompute_interval = recompute_interval
        self._num_virtual_stages = num_virtual_pipeline_stages or 1
        if num_stages is None and topology is None:
            raise ValueError("should provide num_stages or topology")
        if num_stages is None:
            names = topology.get_hybrid_group_names()
            axis = "pp" if "pp" in names else "pipe"
            num_stages = topology.get_dim(axis)
        self._num_stages = int(num_stages)

        seg = SegmentLayers(self._layers_desc, self._num_stages, seg_method)
        self.segment_parts = seg.do_segment()
        if self._num_virtual_stages > 1:
            self.chunk_parts = SegmentLayers(
                self._layers_desc, self.num_chunks, seg_method).do_segment()
        else:
            self.chunk_parts = self.segment_parts

        self._hcg = _pipeline_group(self._num_stages)
        self._stage = None if self._hcg is None else self._hcg.get_stage_id()
        self._shared: dict = {}
        self._shared_forward: dict = {}
        self._shared_groups: dict = {}
        self.run_function: List[Any] = []
        for i, d in enumerate(self._layers_desc):
            if not self._holds(i):
                self.run_function.append(None)
                continue
            if isinstance(d, SharedLayerDesc):
                if d.layer_name not in self._shared:
                    self._shared[d.layer_name] = d.build_layer()
                built = self._shared[d.layer_name]
                if d.forward_func is not None:
                    self._shared_forward[i] = (built, d.forward_func)
                self.run_function.append(built)
                self.add_module(f"shared_{d.layer_name}_{i}", built)
            elif isinstance(d, LayerDesc):
                built = d.build_layer()
                self.run_function.append(built)
                self.add_module(str(i), built)
            elif isinstance(d, torch.nn.Module):
                self.run_function.append(d)
                self.add_module(str(i), d)
            elif callable(d):
                self.run_function.append(d)
            else:
                raise TypeError(f"unsupported layer entry: {d!r}")
        if self._hcg is not None:
            self._tie_shared_layers()

    # --- where each layer lives ------------------------------------------
    def _chunk_of(self, layer_idx: int) -> int:
        for c in range(self.num_chunks):
            if self.chunk_parts[c] <= layer_idx < self.chunk_parts[c + 1]:
                return c
        raise ValueError(f"layer index {layer_idx} out of range")

    def _holds(self, layer_idx: int) -> bool:
        return self._stage is None \
            or self._chunk_of(layer_idx) % self._num_stages == self._stage

    def _tie_shared_layers(self):
        """A group per shared key over the stages that hold it (every rank
        makes every group, in one order), and the key's parameters
        broadcast from the first of those stages."""
        from ...communication.group import new_group
        from ...parallel_wrapper import broadcast_state

        holders = {}
        for i, d in enumerate(self._layers_desc):
            if isinstance(d, SharedLayerDesc):
                stage = self._chunk_of(i) % self._num_stages
                holders.setdefault(d.layer_name, set()).add(stage)
        me = self._hcg.get_global_rank()
        for key in sorted(holders):
            stages = sorted(holders[key])
            if len(stages) < 2:
                continue
            for line in self._hcg.topology.get_comm_list("pp"):
                group = new_group([line[s] for s in stages])
                if me in group.ranks:
                    self._shared_groups[key] = group
        for key, group in self._shared_groups.items():
            broadcast_state(self._shared[key], group)

    def allreduce_shared_weight_gradients(self):
        """Sum each shared layer's gradients over the stages that hold it
        (over ranks; nothing in one process, where it is one layer)."""
        from ...communication import all_reduce

        for key, group in self._shared_groups.items():
            for p in self._shared[key].parameters():
                if p.grad is not None:
                    all_reduce(p.grad, group=group)

    # --- stage queries ---------------------------------------------------
    @property
    def num_stages(self) -> int:
        return self._num_stages

    @property
    def num_chunks(self) -> int:
        return self._num_stages * self._num_virtual_stages

    @property
    def stage(self):
        """This rank's stage over a pipeline group, else None (every
        stage here)."""
        return self._stage

    def get_stage_from_index(self, layer_idx: int) -> int:
        for s in range(self._num_stages):
            if self.segment_parts[s] <= layer_idx < self.segment_parts[s + 1]:
                return s
        raise ValueError(f"layer index {layer_idx} out of range")

    def stage_layers(self, stage: int) -> List[Any]:
        lo, hi = self.segment_parts[stage], self.segment_parts[stage + 1]
        return self.run_function[lo:hi]

    def get_num_items(self) -> int:
        return len(self._layers_desc)

    # --- execution -------------------------------------------------------
    def _run_range(self, x, lo: int, hi: int):
        """Layers [lo, hi), each ``recompute_interval`` of them under one
        ``recompute`` when it is set."""
        if self._recompute_interval > 0:
            from ..utils import recompute

            i = lo
            while i < hi:
                j = min(i + self._recompute_interval, hi)
                x = recompute(self._run_range_plain, x, i, j)
                i = j
            return x
        return self._run_range_plain(x, lo, hi)

    def _run_range_plain(self, x, lo: int, hi: int):
        for i in range(lo, hi):
            fn = self.run_function[i]
            if fn is None:
                raise RuntimeError(
                    f"PipelineLayer: layer {i} lives on another pipeline "
                    f"stage (this rank holds stage {self._stage})")
            if i in self._shared_forward:
                built, fwd = self._shared_forward[i]
                x = fwd(built, x)
            else:
                x = fn(x)
        return x

    def forward_chunk(self, x, chunk: int):
        """One virtual-pipeline chunk."""
        return self._run_range(x, self.chunk_parts[chunk],
                               self.chunk_parts[chunk + 1])

    def chunk_parameters(self, chunk: int):
        """The parameters of one chunk's layers."""
        params = []
        for i in range(self.chunk_parts[chunk], self.chunk_parts[chunk + 1]):
            fn = self.run_function[i]
            if isinstance(fn, torch.nn.Module):
                params.extend(fn.parameters())
        return params

    def forward_stage(self, x, stage: int):
        return self._run_range_plain(x, self.segment_parts[stage],
                                     self.segment_parts[stage + 1])

    def forward(self, x):
        """Every layer in order in one process; over a pipeline group
        without virtual stages, this rank's stage."""
        if self._stage is not None:
            if self._num_virtual_stages > 1:
                raise RuntimeError(
                    "PipelineLayer: over a pipeline group with virtual "
                    "stages a rank holds chunks that are not adjacent; run "
                    "it through PipelineParallel")
            lo, hi = (self.segment_parts[self._stage],
                      self.segment_parts[self._stage + 1])
            return self._run_range(x, lo, hi)
        if self._recompute_interval > 0:
            return self._run_range(x, 0, len(self.run_function))
        for s in range(self._num_stages):
            x = self.forward_stage(x, s)
        return x
