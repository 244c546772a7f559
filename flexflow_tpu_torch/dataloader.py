"""Data loading: a dataset staged once, sliced into batches on the device.

PyTorch counterpart of ``flexflow_tpu/dataloader.py`` (the original
FlexFlow's ``SingleDataLoader``, which stages the whole dataset in
zero-copy host memory once and copies each batch to the GPU by an index
task). Here each array is staged once as a tensor on the model's device
when it fits in the free device memory (``DEVICE_SHARE`` of it), else in
pinned host memory; ``next_batch`` slices the staged tensor. A batch
staged on the card goes into a compiled step's static feeds device to
device: ``fit_loader`` moves no host bytes to the card in steady state.
A pinned batch goes through the step's pinned buffer, one asynchronous
copy.

In a process group of more than one rank every rank stages the whole
dataset and each step's batch is the global batch, of which the
executor feeds the rows the rank's mesh position holds
(``executor.local_feeds``). The ranks agree on ``num_batches`` once, at
construction (``distributed.allgather_value``; the reference's check),
so that ranks handed datasets of other lengths fail with a message
before any of them enters a per-batch collective, instead of hanging.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

# the share of the card's free memory a dataset may take on the device
DEVICE_SHARE = 0.5


def _agree_on_batches(num_batches: int) -> None:
    """Raise unless every rank of the process group computed
    ``num_batches`` (one collective; nothing without a group)."""
    from flexflow_tpu_torch import distributed
    counts = distributed.allgather_value(num_batches)
    if len(set(counts)) != 1:
        raise ValueError(
            f"data loader: the ranks' num_batches disagree {counts} (rank "
            f"{distributed.process_index()} computed {num_batches}): every "
            f"rank must stage a dataset of the same length; pad or "
            f"truncate before making the loader")


def stage(arr: np.ndarray, device, on_device: bool = True) -> torch.Tensor:
    """``arr`` as one tensor, staged once: on ``device`` (None: the card;
    raises without one) when ``on_device`` and it fits in
    ``DEVICE_SHARE`` of the card's free memory (any size on the CPU),
    else in pinned host memory (plain host memory where the model runs on
    the CPU)."""
    from flexflow_tpu_torch.machine import resolve_device
    device = resolve_device(device)  # the card, or an error without one
    host = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return host.to(device)
    if on_device:
        free, _ = torch.cuda.mem_get_info(device)
        if host.numel() * host.element_size() <= DEVICE_SHARE * free:
            return host.to(device)
    return host.pin_memory()


class SingleDataLoader:
    """One input's (or the labels') loader over ``full_array``.

    The usable samples are the whole batches (the reference truncates the
    same way); ``next_batch`` wraps around at the end of an epoch."""

    def __init__(self, ffmodel, input_name: Optional[str], full_array,
                 batch_size: Optional[int] = None,
                 stage_on_device: bool = True):
        self.ff = ffmodel
        self.input_name = input_name  # None: the labels
        arr = np.asarray(full_array)
        if input_name is not None:
            from flexflow_tpu_torch.model import host_input
            names = ffmodel.executor.input_names
            arr = host_input(arr, ffmodel.input_tensors[
                names.index(input_name)])
        bs = batch_size or ffmodel.input_tensors[0].shape[0]
        self.batch_size = bs
        usable = (arr.shape[0] // bs) * bs
        if usable == 0:
            raise ValueError(f"dataset of {arr.shape[0]} samples < batch "
                             f"size {bs}")
        self.num_batches = usable // bs
        _agree_on_batches(self.num_batches)
        self.num_samples = usable
        self.data = stage(arr[:usable], ffmodel.device, stage_on_device)
        self.next_index = 0

    @property
    def on_device(self) -> bool:
        """Whether the dataset lives on the model's device (not in
        pinned host memory)."""
        return self.data.device.type == self.ff.device.type

    def reset(self) -> None:
        self.next_index = 0

    def seek(self, batch_index: int) -> None:
        """Position the loader at ``batch_index`` (0-based within the
        epoch): the next ``next_batch`` returns that batch (the resume's
        one-shot reposition)."""
        b = int(batch_index)
        if not 0 <= b < self.num_batches:
            raise ValueError(f"seek({batch_index}) out of range for a "
                             f"loader with {self.num_batches} batches per "
                             f"epoch")
        self.next_index = b * self.batch_size

    def next_batch(self, _ff=None) -> torch.Tensor:
        """The next batch, a view of the staged tensor (wrapping around
        at the end, as the reference's loader reloads each epoch)."""
        if self.next_index + self.batch_size > self.num_samples:
            self.next_index = 0
        start = self.next_index
        self.next_index += self.batch_size
        return self.data[start:start + self.batch_size]


class DataLoaderSet:
    """Every input's loader and the labels' loader of a compiled model;
    ``fit_loader`` drives it."""

    def __init__(self, ffmodel, xs: Sequence, y,
                 batch_size: Optional[int] = None,
                 stage_on_device: bool = True):
        if ffmodel.executor is None:
            raise ValueError("compile() the model before making its loaders")
        names = ffmodel.executor.input_names
        xs = xs if isinstance(xs, (list, tuple)) else [xs]
        if len(xs) != len(names):
            raise ValueError(f"model has {len(names)} inputs, got {len(xs)}")
        self.input_loaders = [
            SingleDataLoader(ffmodel, n, x, batch_size, stage_on_device)
            for n, x in zip(names, xs)]
        self.label_loader = SingleDataLoader(ffmodel, None, y, batch_size,
                                             stage_on_device)
        counts = {l.num_samples
                  for l in self.input_loaders + [self.label_loader]}
        if len(counts) != 1:
            raise ValueError(
                f"input/label loaders disagree on usable sample count "
                f"{sorted(counts)}: all arrays must have the same length")
        self.ff = ffmodel

    @property
    def num_batches(self) -> int:
        return self.input_loaders[0].num_batches

    def reset(self) -> None:
        for l in self.input_loaders + [self.label_loader]:
            l.reset()

    def seek(self, batch_index: int) -> None:
        """Reposition every loader at ``batch_index`` within the epoch
        (``fit_loader``'s resume)."""
        for l in self.input_loaders + [self.label_loader]:
            l.seek(batch_index)

    def next_batch(self):
        """({input name: batch}, label batch)."""
        inputs = {l.input_name: l.next_batch() for l in self.input_loaders}
        return inputs, self.label_loader.next_batch()


def create_data_loaders(ffmodel, x, y, batch_size: Optional[int] = None,
                        stage_on_device: bool = True) -> DataLoaderSet:
    """The reference's ``ffmodel.create_data_loader`` sugar."""
    return DataLoaderSet(ffmodel, x, y, batch_size, stage_on_device)
