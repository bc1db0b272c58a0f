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


def _included(src: str) -> set[str]:
    """The names a source or header includes in quotes."""
    with open(src) as f:
        return {line.split('"')[1] for line in f
                if line.startswith('#include "')}


@pytest.mark.parametrize("wrapper", [pf, fa], ids=["prefill", "flash"])
def test_k1_and_k4_libraries_are_keyed_by_the_shared_header(wrapper):
    """Both wrappers name the two shared headers, the bf16 tile code and the
    f32 forward body; they exist, each source includes the f32 header by
    name and that one the bf16 header, and the key of each library covers
    each of them."""
    assert wrapper.HEADERS == fa.HEADERS
    mma, f32 = wrapper.HEADERS
    assert os.path.basename(mma) == "mma_tiles.cuh"
    assert os.path.basename(f32) == "f32_tiles.cuh"
    (src,) = wrapper.SOURCES
    assert "f32_tiles.cuh" in _included(src)
    assert "mma_tiles.cuh" in _included(f32)
    key = build.library_path("x", wrapper.SOURCES, wrapper.HEADERS)
    for hdr in wrapper.HEADERS:
        assert os.path.isfile(hdr)
        assert key != build.library_path(
            "x", wrapper.SOURCES, [h for h in wrapper.HEADERS if h != hdr])
        assert hdr not in build.compile_args("x.so", wrapper.SOURCES,
                                             wrapper.HEADERS)


def test_k5_library_is_keyed_by_the_shared_header():
    """K5's kernels take their tile and copy helpers from the same bf16
    header (and not the f32 one): its source includes it by name and its
    library key covers it."""
    assert k5.HEADERS == fa.HEADERS[:1]
    (src,) = k5.SOURCES
    with open(src) as f:
        assert f'#include "{os.path.basename(k5.HEADERS[0])}"' in f.read()
    assert build.library_path("x", k5.SOURCES, k5.HEADERS) != \
        build.library_path("x", k5.SOURCES)
