"""The C++ PTB tokenizer, Porter2 stemmer and METEOR aligner (ctypes loader;
counterpart of `dlsg_tpu/native/__init__.py`).

`ptb_meteor.cpp` (this package's copy of the JAX package's source) is built
at first use with ``g++ -O2 -std=c++17 -fPIC -shared`` into
`build/dlsg_tpu_torch/` beside the package (`$CXX` picks another compiler).
The library's file name carries a digest of the source, the compiler and
the flags, so an edited source is never served from an old build. A build
or load that fails raises with the compiler's output: scoring never drops
to the Python implementations on its own.

The Python implementations in `metrics/` stay the reference; the library
gives the same results (tests/test_torch_native.py). As in the JAX package
they are taken where the text is not ASCII, for a reference of more than
64 words, and for custom METEOR tables the library cannot hold
(`metrics/meteor.py::_sync_native`). To score through Python on purpose,
replace `ptb_tokenize` and `meteor_stats` with functions that return None
(the metrics modules look both up here at each call).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional

SOURCE = Path(__file__).resolve().parent / "ptb_meteor.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dlsg_tpu_torch"
DATA_DIR = Path(__file__).resolve().parent.parent / "metrics" / "data"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_SIGNATURES = {
    "dlsg_ptb_tokenize": ([ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int], ctypes.c_int),
    "dlsg_porter2_stem": ([ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int], ctypes.c_int),
    "dlsg_meteor_stats": ([ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_double)], ctypes.c_int),
    "dlsg_meteor_load_synonyms": ([ctypes.c_char_p], ctypes.c_int),
    "dlsg_meteor_load_paraphrases": ([ctypes.c_char_p], ctypes.c_int),
    "dlsg_meteor_load_phrases": ([ctypes.c_char_p], ctypes.c_int),
    "dlsg_meteor_load_function_words": ([ctypes.c_char_p], ctypes.c_int),
    "dlsg_meteor_reset_function_words": ([], ctypes.c_int),
}

_lib: Optional[ctypes.CDLL] = None


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join((_cxx(),) + CXX_FLAGS).encode())
    return BUILD_DIR / f"libdlsg_native-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; raise with the compiler's
    output if that fails. Safe to run from several processes at once (each
    writes a file of its own and renames it into place)."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"the METEOR/tokenizer library could not be built: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"the METEOR/tokenizer library could not be built (exit {proc.returncode}): "
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The bound library, built first if needed, with the shipped METEOR
    tables installed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _install_default_tables(lib)
        _lib = lib
    return _lib


def _install_default_tables(lib: ctypes.CDLL) -> None:
    """The tables the Python METEOR reads by default (`metrics/data/`)."""
    lib.dlsg_meteor_reset_function_words()
    for loader, name in (
        (lib.dlsg_meteor_load_synonyms, "synonyms.txt"),
        (lib.dlsg_meteor_load_paraphrases, "paraphrases.txt"),
        (lib.dlsg_meteor_load_phrases, "phrase_paraphrases.txt"),
    ):
        if loader(str(DATA_DIR / name).encode()) < 0:
            raise RuntimeError(f"the METEOR library could not read {DATA_DIR / name}")


def reload_default_tables() -> None:
    """Re-install the shipped METEOR tables into a loaded library (a library
    loaded later installs them itself)."""
    if _lib is not None:
        _install_default_tables(_lib)


def _string_call(fn, arg: bytes, *extra) -> str:
    """Call a C function that writes a string of the length it returns into
    a buffer, with a buffer large enough."""
    cap = 4 * len(arg) + 64
    while True:
        buf = ctypes.create_string_buffer(cap)
        n = fn(arg, *extra, buf, cap)
        if n < 0:
            raise RuntimeError(f"{fn.__name__} failed on {arg!r}")
        if n < cap:
            return buf.value.decode()
        cap = n + 1


def ptb_tokenize(line: str, lowercase: bool = True) -> Optional[List[str]]:
    """C++ tokens of one line; None for non-ASCII text (the Python tokenizer
    takes it)."""
    if not line.isascii():
        return None
    return _string_call(load().dlsg_ptb_tokenize, line.encode(), int(lowercase)).split()


def porter2_stem(word: str) -> Optional[str]:
    """C++ Porter2 stem; None for a non-ASCII word."""
    if not word.isascii():
        return None
    return _string_call(load().dlsg_porter2_stem, word.encode())


# the aligner keeps the reference words it has used in a 64-bit mask
MAX_REF_WORDS = 64


def meteor_stats(hyp: str, ref: str):
    """(wp_num, wp_den, wr_num, wr_den, chunks, matches) of one pair from the
    C++ aligner; None for non-ASCII text and for a reference of more than
    MAX_REF_WORDS words."""
    if not (hyp.isascii() and ref.isascii()) or len(ref.split()) > MAX_REF_WORDS:
        return None
    stats = (ctypes.c_double * 6)()
    if load().dlsg_meteor_stats(hyp.encode(), ref.encode(), stats) != 0:
        raise RuntimeError(f"dlsg_meteor_stats failed on {hyp!r} / {ref!r}")
    return tuple(stats)
