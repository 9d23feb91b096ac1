"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points run on the card unless the caller asks for the CPU, and
what is not ported yet raises instead of running something else."""

import ast
import pathlib

import pytest
import torch

from extpom_tpu_torch.cases.seamount import seamount_model
from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.kernels import build

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "extpom_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top == "extpom_tpu"


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        seamount_model(im=9, jm=9, kb=5)


def test_config_matches_jax_fields():
    """Config keeps the JAX package's physics and numerics fields, with the
    same defaults, so both packages build from the same kwargs."""
    from extpom_tpu.core.config import Config as JxConfig
    import dataclasses
    jx = {f.name: f.default for f in dataclasses.fields(JxConfig)}
    for f in dataclasses.fields(Config):
        assert f.name in jx, f.name
        assert f.default == jx[f.name], f.name
    cfg = Config(im=9, jm=9, kb=5, dtype="float64")
    jcfg = JxConfig(im=9, jm=9, kb=5, dtype="float64")
    for prop in ("dti", "dte2", "dti2", "iend", "iprint", "iswtch",
                 "iprint2", "irestart", "ispi", "isp2i", "kbm1", "kbm2"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop


@pytest.mark.parametrize("kw", [dict(mode=2), dict(npg=2), dict(nadv=2),
                                dict(bc_scheme="orlanski"),
                                dict(bc_scheme="file")])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError):
        m = seamount_model(device="cpu", im=9, jm=9, kb=5, dtype="float64",
                           **kw)
        m.run_segment(2)


def test_kernels_not_built_at_import():
    """Importing the kernel modules builds nothing; the build needs nvcc,
    which only the machine with the card has."""
    import extpom_tpu_torch.kernels.extloop  # noqa: F401
    import extpom_tpu_torch.kernels.tridiag  # noqa: F401
    assert build._lib is None
