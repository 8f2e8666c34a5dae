"""The port stands alone: importing every modem_tpu_torch module loads
neither jax nor the JAX package (the GPU machine has no JAX)."""

import os
import pathlib
import subprocess
import sys

import modem_tpu_torch

ROOT = pathlib.Path(modem_tpu_torch.__file__).resolve().parent


def all_modules():
    mods = []
    for path in sorted(ROOT.rglob("*.py")):
        rel = path.relative_to(ROOT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_every_module_is_listed():
    mods = all_modules()
    for name in ("modem_tpu_torch.pipeline", "modem_tpu_torch.state",
                 "modem_tpu_torch.kernels.sc_decode",
                 "modem_tpu_torch.kernels.scl_decode",
                 "modem_tpu_torch.fec.schedule",
                 "modem_tpu_torch.decoder", "modem_tpu_torch.dsp",
                 "modem_tpu_torch.fec.osd", "modem_tpu_torch.fec.scl_np",
                 "modem_tpu_torch.kernels.unroll", "modem_tpu_torch.card",
                 "modem_tpu_torch.probes", "modem_tpu_torch.probes.p256",
                 "modem_tpu_torch.probes.rank3",
                 "modem_tpu_torch.probes.interleave"):
        assert name in mods


def test_no_jax_import():
    prog = ("import importlib, sys\n"
            f"for m in {all_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "roots = ('jax', 'jaxlib', 'modem_tpu')\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in roots)\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT.parent)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", prog], env=env,
                         cwd=ROOT.parent, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_csrc_is_packaged():
    for name in ("sc_decode", "scl_decode", "probe_p256", "probe_rank3",
                 "probe_interleave"):
        assert (ROOT / "csrc" / f"{name}.cu").exists()
