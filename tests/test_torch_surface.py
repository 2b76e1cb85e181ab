"""The port's public surface against the reference's, on the CPU.

Every module of ``hyres_tpu`` (each ``.py`` source under the package;
the shared library that ``hyres_tpu/coding/build.py`` compiles beside its
sources is a build output, not a module) is imported, and its public
names are collected:

- every top-level name defined there: a function or class whose
  ``__module__`` is that module, or a name the module's source assigns at
  its top level (constants);
- every ``__all__`` entry of a subpackage;
- every public method of a public class defined there.

Each must exist at the same dotted path under ``hyres_tpu_torch``, or
have an entry in ``MAP``, which names the counterpart or says why there
is none. A new public name of ``hyres_tpu`` with neither fails here. A
module that does not import on the CPU needs an entry of its own.
"""

from __future__ import annotations

import ast
import importlib
import inspect
import pkgutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

TPU_NAMES = "Tpu* names are Device* in the port: its coder runs on the card"
TPU_KNOB = ("an environment knob that picks among TPU lowerings; the port has one "
            "lowering (the CUDA kernels of kernels/rans.py)")
PALLAS_ONLY = ("a helper of the Pallas lowering (a self-test probe, a lane-tier "
               "gate or a TPU tile size); the port's wrappers launch or raise")
FLAX_SETUP = "flax's lazy set-up; an nn.Module builds its layers in __init__"

# JAX name (or module, or class) -> (counterpart in the port or None, why).
# A counterpart replaces the key's prefix of every name under it.
MAP = {
    "hyres_tpu.coding.tpu_rans": ("hyres_tpu_torch.coding.device_rans", TPU_NAMES),
    "hyres_tpu.coding.tpu_rans.TpuCoderTables": (
        "hyres_tpu_torch.coding.device_rans.DeviceCoderTables", TPU_NAMES),
    "hyres_tpu.coding.tpu_rans.is_tpu_frame": (
        "hyres_tpu_torch.coding.device_rans.is_device_frame", TPU_NAMES),
    "hyres_tpu.coding.tpu_rans.gauss_decode": (
        "hyres_tpu_torch.coding.device_rans.gauss_decode_batch",
        "the port's device_rans.gauss_decode is already batched; one plane is a "
        "batch of one"),
    "hyres_tpu.coding.tpu_rans.GAUSS_IMPL": (None, TPU_KNOB),
    "hyres_tpu.coding.tpu_rans.SCAN_UNROLL": (None, TPU_KNOB),
    "hyres_tpu.coding.tpu_rans.STREAM_READ": (None, TPU_KNOB),
    "hyres_tpu.coding.tpu_rans.PREFIX_MODE": (None, TPU_KNOB),
    "hyres_tpu.coding.tpu_rans.COMPACT_MODE": (None, TPU_KNOB),
    "hyres_tpu.coding.pallas_rans": (
        "hyres_tpu_torch.coding.device_rans",
        "the Pallas lowering of tpu_rans's batch entry points; the port's launch "
        "the CUDA kernels of kernels/rans.py"),
    "hyres_tpu.coding.pallas_rans.eb_decode_batch": (
        "hyres_tpu_torch.coding.device_rans.rans_decode_batch", "tpu_rans's name"),
    "hyres_tpu.coding.pallas_rans.eb_encode_batch": (
        "hyres_tpu_torch.coding.device_rans.rans_encode_batch", "tpu_rans's name"),
    "hyres_tpu.coding.pallas_rans.fused_encode_batch": (
        "hyres_tpu_torch.coding.device_rans.fused_encode_planes", "tpu_rans's name"),
    "hyres_tpu.coding.pallas_rans.probe": (None, PALLAS_ONLY),
    "hyres_tpu.coding.pallas_rans.probe_eb": (None, PALLAS_ONLY),
    "hyres_tpu.coding.pallas_rans.probe_enc": (None, PALLAS_ONLY),
    "hyres_tpu.coding.pallas_rans.supported": (None, PALLAS_ONLY),
    "hyres_tpu.coding.pallas_rans.MAX_G": (None, PALLAS_ONLY),
    "hyres_tpu.coding.pallas_rans.TC": (None, PALLAS_ONLY),
    "hyres_tpu.entropy.bottleneck.EntropyBottleneck.setup": (None, FLAX_SETUP),
    "hyres_tpu.models.checkerboard.LightWeightCheckerboard.setup": (None, FLAX_SETUP),
    "hyres_tpu.models.cheng2020.Cheng2020withCheckerboard.setup": (None, FLAX_SETUP),
    "hyres_tpu.models.elic.LightWeightELIC.setup": (None, FLAX_SETUP),
    "hyres_tpu.models.hyres.ResidualJPEGCompression.setup": (None, FLAX_SETUP),
    "hyres_tpu.models.codec.TpuPlaneCoder": (
        "hyres_tpu_torch.models.codec.DevicePlaneCoder", TPU_NAMES),
}


def _jax_modules() -> list:
    """Every module of ``hyres_tpu`` from its sources, without importing."""
    out = []

    def walk(path: Path, prefix: str):
        for m in pkgutil.iter_modules([str(path)]):
            if m.ispkg:
                out.append(prefix + m.name)
                walk(path / m.name, prefix + m.name + ".")
            elif (path / f"{m.name}.py").exists():
                out.append(prefix + m.name)

    out.append("hyres_tpu")
    walk(ROOT / "hyres_tpu", "hyres_tpu.")
    return sorted(out)


JAX_MODULES = _jax_modules()


def _assigned(mod) -> set:
    """Names the module's source assigns at its top level."""
    tree = ast.parse(Path(mod.__file__).read_text())
    names = set()
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign) else [])
        names |= {t.id for t in targets if isinstance(t, ast.Name)}
    return names


def public_names(mod) -> list:
    """The module's public surface as dotted paths (see the docstring)."""
    name = mod.__name__
    assigned = _assigned(mod)
    out = set()
    for k, v in vars(mod).items():
        if k.startswith("_") or inspect.ismodule(v):
            continue
        own = getattr(v, "__module__", None) == name
        if not (own or k in assigned):
            continue
        out.add(f"{name}.{k}")
        if inspect.isclass(v) and own:
            out |= {f"{name}.{k}.{a}" for a, f in vars(v).items()
                    if not a.startswith("_")
                    and (callable(f) or isinstance(f, (staticmethod, classmethod, property)))}
    if hasattr(mod, "__path__"):
        out |= {f"{name}.{k}" for k in getattr(mod, "__all__", ())}
    return sorted(out)


def resolve(path: str) -> bool:
    """True iff ``path`` names a module or an attribute chain below one."""
    parts = path.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        for p in parts[i:]:
            if not hasattr(obj, p):
                return False
            obj = getattr(obj, p)
        return True
    return False


def _entry(name: str):
    """The longest MAP key that is ``name`` or a dotted prefix of it."""
    keys = [k for k in MAP if name == k or name.startswith(k + ".")]
    return max(keys, key=len) if keys else None


def counterpart_missing(name: str) -> bool:
    """True iff ``name`` has neither a port counterpart nor a reason."""
    key = _entry(name)
    if key is None:
        return not resolve("hyres_tpu_torch" + name[len("hyres_tpu"):])
    target, _ = MAP[key]
    return target is not None and not resolve(target + name[len(key):])


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart_or_a_reason(module):
    try:
        mod = importlib.import_module(module)
    except Exception as e:  # noqa: BLE001 - any import failure needs its entry
        assert module in MAP, f"{module} does not import on the CPU ({e!r}) and has no entry"
        return
    missing = [n for n in public_names(mod) if counterpart_missing(n)]
    assert not missing, f"no counterpart and no reason in MAP: {missing}"


def test_map_entries_are_live_and_explained():
    """Each entry names a JAX module or public name, gives a reason, and
    its counterpart exists."""
    walked = set(JAX_MODULES)
    for m in JAX_MODULES:
        walked |= set(public_names(importlib.import_module(m)))
    for key, (target, why) in MAP.items():
        assert key in walked, f"stale entry {key}"
        assert why.strip(), key
        assert target is None or resolve(target), f"{key}: {target} does not exist"


def test_walk_covers_the_package():
    assert len(JAX_MODULES) == len(list((ROOT / "hyres_tpu").rglob("*.py")))
    assert {"hyres_tpu.coding.tpu_rans", "hyres_tpu.cli.training"} <= set(JAX_MODULES)


def test_an_unported_name_is_caught():
    """The check itself: a name without a counterpart or entry is missing,
    a renamed one maps, and a reason covers its own name only."""
    assert counterpart_missing("hyres_tpu.coding.rans.NotPorted")
    assert counterpart_missing("hyres_tpu.coding.tpu_rans.not_ported")
    assert not counterpart_missing("hyres_tpu.coding.tpu_rans.TpuCoderTables.to")
    assert not counterpart_missing("hyres_tpu.coding.pallas_rans.probe")
    assert counterpart_missing("hyres_tpu.coding.pallas_rans.probe_more")
