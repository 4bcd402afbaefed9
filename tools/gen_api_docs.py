"""Generate docs/api.md — the package API reference — from docstrings.

The reference ships a Sphinx site (/root/reference/docs/source/); this
repo's equivalent is a single generated markdown reference: every public
module, its docstring header, and each public function/class with its
signature and summary paragraph. Deterministic output, checked in —
regenerate with ``python tools/gen_api_docs.py``.
"""

import importlib
import inspect
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

MODULES = [
    "opticommpy_tpu.ops.filtering",
    "opticommpy_tpu.ops.signal",
    "opticommpy_tpu.ops.noise",
    "opticommpy_tpu.comm.modulation",
    "opticommpy_tpu.comm.sources",
    "opticommpy_tpu.comm.metrics",
    "opticommpy_tpu.comm.ofdm",
    "opticommpy_tpu.comm.fec",
    "opticommpy_tpu.comm.fec_qc",
    "opticommpy_tpu.comm.fec_lift",
    "opticommpy_tpu.comm.codes",
    "opticommpy_tpu.models.config",
    "opticommpy_tpu.models.devices",
    "opticommpy_tpu.models.channels",
    "opticommpy_tpu.models.tx",
    "opticommpy_tpu.models.amplification",
    "opticommpy_tpu.models.perturbation",
    "opticommpy_tpu.dsp.equalization",
    "opticommpy_tpu.dsp.carrier_recovery",
    "opticommpy_tpu.dsp.clock_recovery",
    "opticommpy_tpu.dsp.synchronization",
    "opticommpy_tpu.pipelines",
    "opticommpy_tpu.parallel",
    "opticommpy_tpu.parallel.sharded",
    "opticommpy_tpu.parallel.distributed",
    "opticommpy_tpu.kernels.mimo_pallas",
    "opticommpy_tpu.backend",
    "opticommpy_tpu.native",
    "opticommpy_tpu.utils.units",
    "opticommpy_tpu.utils.bits",
    "opticommpy_tpu.utils.checkpoint",
    "opticommpy_tpu.utils.profiling",
    "opticommpy_tpu.plot",
    "opticommpy_tpu.compat",
]


def first_para(doc):
    if not doc:
        return "*(undocumented)*"
    doc = inspect.cleandoc(doc)
    return doc.split("\n\n")[0].replace("\n", " ")


def sig_of(obj):
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def public_members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for n in sorted(names):
        obj = getattr(mod, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        # keep only members defined in (or re-exported by) the package
        owner = getattr(obj, "__module__", "") or ""
        if not owner.startswith("opticommpy_tpu"):
            continue
        if inspect.isfunction(obj) or inspect.isclass(obj):
            out.append((n, obj))
    return out


def main():
    lines = [
        "# opticommpy-tpu API reference",
        "",
        "Generated from docstrings by `tools/gen_api_docs.py` — regenerate "
        "after API changes. Reference-parity citations (`file:line` into "
        "`/root/reference/optic`) live in the full docstrings; see also "
        "`PARITY.md` for the component mapping and `docs/migrating.md` "
        "for the reference-API bridge (`opticommpy_tpu.compat`).",
        "",
    ]
    for name in MODULES:
        mod = importlib.import_module(name)
        lines.append(f"## `{name}`")
        lines.append("")
        lines.append(first_para(mod.__doc__))
        lines.append("")
        for n, obj in public_members(mod):
            kind = "class" if inspect.isclass(obj) else "def"
            lines.append(f"### `{kind} {n}{sig_of(obj)}`")
            lines.append("")
            lines.append(first_para(obj.__doc__))
            lines.append("")
            if inspect.isclass(obj):
                for mn, mobj in sorted(vars(obj).items()):
                    if mn.startswith("_") or not inspect.isfunction(mobj):
                        continue
                    lines.append(f"- `.{mn}{sig_of(mobj)}` — "
                                 f"{first_para(mobj.__doc__)}")
                lines.append("")
    out_path = os.path.join(ROOT, "docs", "api.md")
    with open(out_path, "w") as f:
        f.write("\n".join(lines).rstrip() + "\n")
    print(f"wrote {out_path} ({len(lines)} lines, {len(MODULES)} modules)")


if __name__ == "__main__":
    main()
