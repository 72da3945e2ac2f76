"""What the kernel-variant tools share: a parallel nvcc build of text-edited
copies of a kernel source, and timing in turns.

``tools/torch_mf_variants.py``, ``tools/torch_gardner_variants.py`` and
``tools/torch_bch_variants.py`` import it (they run as scripts, so this
directory is on their path).
"""

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def apply_edits(text, edits):
    """``text`` with each (old, new) of ``edits`` replaced; each old text
    must occur exactly once, so an edit that no longer fits its source
    fails loudly instead of doing nothing."""
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"edit does not fit its source once: {old!r}")
        text = text.replace(old, new)
    return text


def build(out_dir, sources):
    """Compile every {name: CUDA source text} with the package's nvcc flags
    into ``out_dir/<name>.so``, all processes at once. Returns ({name:
    ctypes.CDLL}, {name: nvcc's output, the -Xptxas -v report}); raises
    with the log if one fails."""
    from dvbs2rx_tpu_torch import _build

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in sources.items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        so = out / f"{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
               str(cu)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs, logs = {}, {}
    for name, (so, p) in jobs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name], logs[name] = ctypes.CDLL(str(so)), log
    return libs, logs


def bind(lib, signatures, prefix):
    """Set argtypes (and an int result) for every function of
    ``signatures`` ({name: argtypes}, as ``_build._SIGNATURES``) whose name
    starts with ``prefix``."""
    for fn, args in signatures.items():
        if fn.startswith(prefix):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int


def time_in_turns(calls, rounds, runs):
    """{name: [ms, ...]}: each round times every call of ``calls`` ({name:
    fn}) with ``chip_smoke._time_ms(fn, runs)``, in order and then in
    reverse, so a drift of the card's clock over the run falls on all."""
    import chip_smoke

    names = list(calls)
    times = {name: [] for name in names}
    for _ in range(rounds):
        for name in names + names[::-1]:
            times[name].append(chip_smoke._time_ms(calls[name], runs))
    return times
