"""IISPTNet training: Adam 6e-5, L1 loss, batch 32, epoch and time budget
(port of ``ml/train.py`` and of the one-device case of
``parallel/sharded.py::make_train_step``).

The reference's ml/main_train.py:21-156 trains the PyTorch U-Net on one
GPU; so does this module, on the net of ``models/iisptnet.py`` with
flax's BatchNorm semantics.  Convolutions run in fp32 with TF32 off
inside the step, as the renderer's inference does.  Checkpoints:
  - ``save_checkpoint`` / ``load_checkpoint``: the pickle of numpy
    ``params`` / ``batch_stats`` trees that the JAX package writes and its
    CLI's ``--checkpoint`` reads (each package reads the other's file);
  - ``save_pretrained`` / ``load_pretrained``: the flat float16 npz of
    the committed pretrained model;
  - ``save_state`` / ``load_state``: ``torch.save`` of the net, Adam's
    state and the step count, in place of the JAX package's orbax
    checkpoints; training resumes from it bit for bit.
"""

from __future__ import annotations

import pickle
import time

import torch

from ..models import iisptnet
from ..models import weights as weightlib
from ..ops import threefry
from . import dataset as datasetlib
from . import losses as losslib

LEARNING_RATE = 6e-5   # (ref: main_train.py:21)
BATCH_SIZE = 32        # (ref: main_train.py:24)
MAX_EPOCHS = 3         # (ref: main_train.py:22)
TIME_BUDGET_S = 3600.0  # (ref: main_train.py MAX_TRAIN_SECONDS 60 min)


def make_train_step(net, optimizer, loss: str = "l1"):
    """step(x (B, H, W, 7), y (B, H, W, 3)) -> loss (a 0-d tensor): the
    forward pass in training mode (BatchNorm on the batch, running
    statistics updated), the loss, the backward pass and one optimizer
    step.  loss: 'l1' (the reference's, ml/main_train.py:23), 'rel_l1' or
    'rel_mse' (ml/iispt_loss.py)."""
    loss_f = losslib.get(loss)

    def step(x, y):
        net.train()
        with iisptnet.fp32_convolutions(x.device):
            value = loss_f(net(x), y)
            optimizer.zero_grad(set_to_none=True)
            value.backward()
            optimizer.step()
        return value.detach()

    return step


def init_training(generator: torch.Generator, hemi_size: int = 32,
                  device="cuda"):
    """A fresh full-width net initialized as flax does (weights drawn
    from ``generator``), Adam at LEARNING_RATE and the train step, on
    ``device`` (the card unless the caller asks for the CPU).  hemi_size
    is the probe side the net is trained on."""
    net = iisptnet.init_params(iisptnet.IISPTNet(), generator).to(device)
    optimizer = torch.optim.Adam(net.parameters(), lr=LEARNING_RATE)
    return dict(net=net, optimizer=optimizer,
                step=make_train_step(net, optimizer), hemi_size=hemi_size)


def train(raw_examples, state, key, max_epochs: int = MAX_EPOCHS,
          time_budget_s: float = TIME_BUDGET_S, batch_size: int = BATCH_SIZE,
          log_every: int = 10, log=print, max_steps: int = None):
    """Train on raw example dicts (maps p, d, n, z); epoch e draws its
    batches with fold_in(key, e).  Stops after max_epochs, past the time
    budget, or after max_steps steps.  Returns the state (trained in
    place) and the loss of every step."""
    t0 = time.time()
    device = next(state["net"].parameters()).device
    losses = []
    for epoch in range(max_epochs):
        for x, y in datasetlib.batches_from_raw(
                raw_examples, batch_size, threefry.fold_in(key, epoch),
                device=device):
            losses.append(float(state["step"](x, y)))
            if log and len(losses) % log_every == 0:
                log(f"epoch {epoch} it {len(losses)} loss {losses[-1]:.5f}")
            if (time.time() - t0 > time_budget_s
                    or (max_steps is not None and len(losses) >= max_steps)):
                return state, losses
    return state, losses


def inference_variables(state_or_blob) -> dict:
    """{"params", "batch_stats"} numpy trees of a training state (its
    net) or of a loaded checkpoint."""
    if "net" in state_or_blob:
        return weightlib.flax_from_state_dict(state_or_blob["net"].state_dict())
    return {"params": state_or_blob["params"],
            "batch_stats": state_or_blob["batch_stats"]}


def save_checkpoint(path: str, state):
    """The model checkpoint (replaces iispt_model.tch, main_train.py:153):
    a pickle of numpy trees, the JAX package's format."""
    with open(path, "wb") as f:
        pickle.dump(inference_variables(state), f)


def load_checkpoint(path: str) -> dict:
    """Read a ``save_checkpoint`` pickle (either package's) -> numpy trees.
    Unpickle only files that a trainer wrote."""
    with open(path, "rb") as f:
        return inference_variables(pickle.load(f))


def save_pretrained(path: str, state_or_blob):
    """Inference weights as the flat float16 npz of the committed model."""
    weightlib.save_pretrained(path, inference_variables(state_or_blob))


def load_pretrained(path: str) -> dict:
    """A ``save_pretrained`` file -> inference variables (numpy trees)."""
    return weightlib.flax_from_state_dict(weightlib.load_iisptnet_npz(path))


def default_pretrained_path() -> str:
    """The committed pretrained model (read only, never written)."""
    return weightlib.DEFAULT_NPZ


def save_state(path: str, state, step: int = 0):
    """Net, Adam's state and the step count, with ``torch.save``."""
    torch.save({"net": state["net"].state_dict(),
                "optimizer": state["optimizer"].state_dict(),
                "step": int(step)}, path)


def load_state(path: str, state):
    """Restore a ``save_state`` file into an ``init_training`` state (the
    net's width must match).  Returns (state, step)."""
    device = next(state["net"].parameters()).device
    blob = torch.load(path, map_location=device, weights_only=True)
    state["net"].load_state_dict(blob["net"])
    state["optimizer"].load_state_dict(blob["optimizer"])
    return state, blob["step"]
