"""Lightning ``.ckpt`` container ingestion (host-side).

The reference distributes trained weights as PyTorch-Lightning checkpoint
containers (e.g. ``models/action/four-chars-aug-4.ckpt``, loaded with
``CNNActionDetector.load_from_checkpoint`` — reference: ai_runner.py:164-168).
A Lightning checkpoint is a ``torch.save`` pickle holding ``state_dict``
(module-qualified tensor names), ``hyper_parameters``, optimizer states,
and assorted trainer bookkeeping.

This module extracts the ``state_dict`` WITHOUT importing the reference's
classes: a plain ``torch.load(weights_only=True)`` is attempted first; when
the container embeds arbitrary objects (Lightning's AttributeDict,
argparse.Namespace, custom callbacks...), a restricted unpickler loads it
with every non-allowlisted class replaced by an inert stub — tensors come
through intact, everything else degrades to stubs we never read.

The port's own copy of ``playaid_core_tpu/models/lightning_ckpt.py``.  The
extracted tensors feed the same structural converters
(:mod:`playaid_core_torch.models.torch_convert`, a copy of the JAX
package's) and land in split ``{embed, head}`` trees, which
:meth:`playaid_core_torch.infer.pipeline.BatchedActionPipeline.load_checkpoint`
loads into its modules through ``playaid_core_torch/convert.py``.
"""

from __future__ import annotations

import io
import pickle

from playaid_core_torch.models import torch_convert

# Exact globals trusted during unpickling — the tensor-rebuild entry points
# torch's own ``weights_only`` unpickler permits, plus inert container types.
# A module-prefix allowlist is NOT safe here: ``builtins`` contains
# ``eval``/``exec``/``getattr`` and ``torch`` contains ``torch.load`` itself,
# any of which a crafted container could resolve via GLOBAL+REDUCE.  For the
# same reason ``torch.storage._load_from_bytes`` is not trusted: it calls
# ``torch.load(..., weights_only=False)`` on bytes from the container.
# Everything else becomes _StubObject: constructible with any args, absorbs
# any state.
_SAFE_GLOBALS = {
    ("collections", "OrderedDict"),
    ("collections", "defaultdict"),
    ("torch._utils", "_rebuild_tensor"),
    ("torch._utils", "_rebuild_tensor_v2"),
    ("torch._utils", "_rebuild_parameter"),
    ("torch._utils", "_rebuild_sparse_tensor"),
    ("torch._utils", "_rebuild_meta_tensor_no_storage"),
    ("torch", "Size"),
    ("torch", "device"),
    ("torch", "dtype"),
    ("torch.storage", "TypedStorage"),
    ("torch.storage", "_TypedStorage"),
    ("torch.storage", "UntypedStorage"),
    ("torch.serialization", "_get_layout"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("_codecs", "encode"),
    # Inert builtins that old pickle protocols reach via GLOBAL.
    ("builtins", "set"),
    ("builtins", "frozenset"),
    ("builtins", "bytearray"),
    ("builtins", "complex"),
    ("builtins", "slice"),
    ("builtins", "range"),
}
# torch storage classes live at top level (torch.FloatStorage, ...).
_SAFE_GLOBALS.update(
    ("torch", n + "Storage")
    for n in ("Float", "Double", "Half", "BFloat16", "Long", "Int", "Short",
              "Char", "Byte", "Bool", "ComplexFloat", "ComplexDouble",
              "QInt8", "QUInt8", "QInt32", "Untyped")
)


class _StubObject:
    """Inert stand-in for unpicklable/untrusted classes inside the
    container (we only ever read ``state_dict``)."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, *args, **kwargs):  # classes used as factories
        return _StubObject()

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)

    def __repr__(self):
        return "<ckpt stub>"


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _SAFE_GLOBALS:
            return super().find_class(module, name)
        return _StubObject


class _RestrictedPickleModule:
    """Duck-typed ``pickle`` module handed to ``torch.load``."""

    Unpickler = _RestrictedUnpickler

    @staticmethod
    def load(f, **kwargs):
        kwargs.pop("encoding", None)
        return _RestrictedUnpickler(f).load()

    @staticmethod
    def loads(data, **kwargs):
        return _RestrictedUnpickler(io.BytesIO(data)).load()


def load_lightning_checkpoint(path):
    """Load a Lightning ``.ckpt`` container -> dict (state_dict intact,
    untrusted embedded objects stubbed)."""
    import torch

    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # weights_only refuses the container's custom objects.
        pass
    return torch.load(
        path, map_location="cpu", weights_only=False,
        pickle_module=_RestrictedPickleModule,
    )


def extract_state_dict(ckpt):
    """Pull the module state dict out of a loaded container (or accept a
    bare state dict)."""
    if hasattr(ckpt, "keys") and "state_dict" in ckpt:
        return ckpt["state_dict"]
    return ckpt


def convert_state_dict(state_dict, family, sequence_length=7):
    """A reference module state dict -> monolithic Flax-layout variables
    for the matching model family ("cnn" | "rnn" | "resformer")."""
    if family == "cnn":
        return torch_convert.convert_cnn_action_detector(state_dict, sequence_length)
    if family == "rnn":
        return torch_convert.convert_rnn_action_detector(state_dict)
    if family == "resformer":
        return torch_convert.convert_resformer_detector(state_dict)
    raise ValueError(f"unknown family: {family}")
