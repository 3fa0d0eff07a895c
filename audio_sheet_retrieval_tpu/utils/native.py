"""Build-on-first-use for the host-side C++ libraries under ``native/``.

Each library is compiled from its committed sources into ``native/build/``
(listed in .gitignore). The file name carries a digest of the sources and
flags, so an edited source builds a new library and a stale one is never
loaded. Build all of them ahead of time with
``python -m audio_sheet_retrieval_tpu.utils.native``.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import tempfile

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
BUILD_DIR = os.path.join(NATIVE_DIR, "build")

# name -> (sources relative to native/, extra link flags)
LIBRARIES = {
    "asraudio": (("audioio/flac_decoder.cpp", "audioio/mp3_decoder.cpp"),
                 ("-ldl",)),
    "asrrans": (("rans/rans_encode.cpp",), ()),
}
_CFLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def lib_path(name: str) -> str:
    """Path of the library built from the current sources."""
    srcs, ldflags = LIBRARIES[name]
    h = hashlib.sha256(" ".join(_CFLAGS + ldflags).encode())
    for src in srcs:
        with open(os.path.join(NATIVE_DIR, src), "rb") as fp:
            h.update(fp.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``name`` unless it is already built; returns its path.
    Raises OSError when no C++ compiler is found and
    subprocess.CalledProcessError when compilation fails."""
    out = lib_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs, ldflags = LIBRARIES[name]
    # compile to a private name, then rename: concurrent builders (test
    # workers, server processes) never load a half-written file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", *_CFLAGS, "-o", tmp,
             *(os.path.join(NATIVE_DIR, s) for s in srcs), *ldflags],
            check=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


if __name__ == "__main__":
    for lib in sys.argv[1:] or LIBRARIES:
        print(build(lib))
