"""The port's kernel build key and compile line, without ``nvcc``.

A library's name is keyed by the bytes of its sources and of the headers
they include, so an edited header rebuilds every library that includes it;
a header is put on the include path and never compiled on its own.
"""

import os

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.mamba_scan import mamba_scan as k5
from repro_torch.kernels.prefill import prefill as pf

torch.set_num_threads(1)


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def test_header_bytes_change_the_library_key(tmp_path):
    src = _write(tmp_path / "k.cu", '#include "tiles.cuh"\n')
    hdr = _write(tmp_path / "tiles.cuh", "// v1\n")
    key = build.library_path("k", [src], [hdr])
    assert key == build.library_path("k", [src], [hdr])
    assert os.path.dirname(key) == build.BUILD_DIR
    assert key != build.library_path("k", [src])
    _write(hdr, "// v2\n")
    assert build.library_path("k", [src], [hdr]) != key


def test_header_is_on_the_include_path_not_the_compile_line(tmp_path):
    src = _write(tmp_path / "k.cu", "")
    os.makedirs(tmp_path / "inc")
    hdr = _write(tmp_path / "inc" / "tiles.cuh", "")
    args = build.compile_args("out.so", [src], [hdr])
    assert hdr not in args and src in args
    assert f"-I{tmp_path / 'inc'}" in args
    assert args[args.index("-o") + 1] == "out.so"
    assert list(build.ARCH_FLAGS) == args[:len(build.ARCH_FLAGS)]


@pytest.mark.parametrize("wrapper", [pf, fa], ids=["prefill", "flash"])
def test_k1_and_k4_libraries_are_keyed_by_the_shared_header(wrapper):
    """Both wrappers name the bf16 tile header; it exists, each source
    includes it by name, and the key of each library covers it."""
    (hdr,) = wrapper.HEADERS
    assert hdr == fa.HEADERS[0] and os.path.isfile(hdr)
    (src,) = wrapper.SOURCES
    with open(src) as f:
        assert f'#include "{os.path.basename(hdr)}"' in f.read()
    assert build.library_path("x", wrapper.SOURCES, wrapper.HEADERS) != \
        build.library_path("x", wrapper.SOURCES)
    assert hdr not in build.compile_args("x.so", wrapper.SOURCES,
                                         wrapper.HEADERS)


def test_k5_library_is_keyed_by_the_shared_header():
    """K5's bf16 kernel takes its tile helpers from the same header: its
    source includes it by name and its library key covers it."""
    assert k5.HEADERS == fa.HEADERS
    (src,) = k5.SOURCES
    with open(src) as f:
        assert f'#include "{os.path.basename(k5.HEADERS[0])}"' in f.read()
    assert build.library_path("x", k5.SOURCES, k5.HEADERS) != \
        build.library_path("x", k5.SOURCES)
