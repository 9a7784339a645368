"""The port's kernel build (ray_tpu_torch.ops._build), the layout
contract of the kernels' tensor maps and the ctypes signatures of their C
entry points, on the CPU: no nvcc runs.

A library's path carries a hash of its source, of every header beside it
and of the flags, so an edited header rebuilds every source that may
include it; an unchanged tree keeps its path, so a built library is
reused."""

import ctypes
import os
import re
import shutil

import pytest
import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.flash_attention import (_ARGTYPES, _aligned,
                                               _kernel_layout)


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "kern.cu").write_text('#include "blocks.cuh"\n')
    (tmp_path / "blocks.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    return tmp_path


def test_unchanged_tree_keeps_the_library_path(csrc):
    assert _build._lib_path("kern.cu") == _build._lib_path("kern.cu")


@pytest.mark.parametrize("edit", ["header", "new_header", "source"])
def test_an_edit_changes_the_library_path(csrc, edit):
    before = _build._lib_path("kern.cu")
    if edit == "header":
        (csrc / "blocks.cuh").write_text("// v2\n")
    elif edit == "new_header":
        (csrc / "more.cuh").write_text("// new\n")
    else:
        (csrc / "kern.cu").write_text('#include "blocks.cuh"\n// edit\n')
    after = _build._lib_path("kern.cu")
    assert after != before
    assert os.path.dirname(after) == _build.BUILD_DIR
    assert os.path.basename(after).startswith("libkern_")


def test_an_edit_of_the_shipped_header_rebuilds_every_source(tmp_path,
                                                              monkeypatch):
    """A copy of the shipped csrc/: editing hopper.cuh moves the library
    path of both kernel sources."""
    shutil.copytree(_build.CSRC, tmp_path / "csrc")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path / "csrc"))
    sources = ("flash_attn_fwd.cu", "flash_attn_bwd.cu")
    before = [_build._lib_path(s) for s in sources]
    with open(tmp_path / "csrc" / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    after = [_build._lib_path(s) for s in sources]
    assert all(a != b for a, b in zip(after, before))


@pytest.mark.parametrize("D", [64, 128])
def test_aligned_takes_a_head_slice_of_a_fused_projection(D):
    """q, k and v cut by head out of one fused (B, S, H + 2 KVH, D)
    projection are read in place: base 16-byte aligned, strides multiples
    of 8 elements, the head dim contiguous."""
    B, S, H, KVH = 2, 16, 4, 2
    fused = torch.zeros(B, S, H + 2 * KVH, D, dtype=torch.bfloat16)
    q, k, v = fused[:, :, :H], fused[:, :, H:H + KVH], fused[:, :, H + KVH:]
    for x in (q, k, v):
        assert not x.is_contiguous()
        assert _aligned(x)


def test_aligned_refuses_a_view_one_element_off():
    B, S, H, D = 2, 16, 4, 64
    flat = torch.zeros(B * S * H * D + 1, dtype=torch.bfloat16)
    x = flat[1:].view(B, S, H, D)
    assert x.data_ptr() % 16 == 2
    assert not _aligned(x)
    assert _aligned(flat[:-1].view(B, S, H, D))


def test_aligned_refuses_a_strided_head_dim_and_odd_strides():
    x = torch.zeros(2, 16, 4, 128, dtype=torch.bfloat16)
    assert not _aligned(x[..., ::2])               # head dim not contiguous
    # A row stride of 260 elements (520 bytes) is no multiple of 16 bytes.
    y = torch.zeros(2, 16, 4 * 64 + 4, dtype=torch.bfloat16)
    assert not _aligned(y[:, :, :256].unflatten(-1, (4, 64)))


def _views_aligned_refuses():
    flat = torch.arange(2 * 16 * 4 * 64 + 1).to(torch.bfloat16)
    wide = torch.arange(2 * 16 * 260).to(torch.bfloat16).view(2, 16, 260)
    return {
        # contiguous, so .contiguous() would return it unchanged
        "base_one_element_off": flat[1:].view(2, 16, 4, 64),
        "strided_head_dim": flat[:-1].view(2, 16, 4, 64)[..., ::2],
        "odd_row_stride": wide[:, :, :256].unflatten(-1, (4, 64)),
    }


@pytest.mark.parametrize("case", sorted(_views_aligned_refuses()))
def test_kernel_layout_copies_what_aligned_refuses(case):
    """What the wrappers hand the kernels meets the tensor maps' layout
    contract, whatever view they were given, with the same values."""
    x = _views_aligned_refuses()[case]
    assert not _aligned(x)
    y = _kernel_layout(x)
    assert _aligned(y)
    assert y.data_ptr() != x.data_ptr()
    assert torch.equal(y, x)


def test_kernel_layout_reads_an_aligned_view_in_place():
    fused = torch.zeros(2, 16, 8, 128, dtype=torch.bfloat16)
    k = fused[:, :, 4:6]
    assert _kernel_layout(k) is k


def _c_argtypes(source, name):
    """The ctypes types of the parameters of the C entry point `name` in
    csrc/`source`, read from the source (a parameter list may be a
    `#define`d macro, as the backward's BWD_ARGS)."""
    with open(os.path.join(_build.CSRC, source)) as f:
        text = f.read()
    params = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", text,
                       re.S).group(1).strip()
    if re.fullmatch(r"\w+", params):
        body = re.search(r"#define " + params + r"((?:.*\\\n)*.*)", text)
        params = body.group(1).replace("\\\n", " ")
    kinds = []
    for p in params.split(","):
        p = " ".join(p.split())
        kinds.append(ctypes.c_void_p if "*" in p
                     else ctypes.c_longlong if p.startswith("long long")
                     else ctypes.c_float if p.startswith("float")
                     else ctypes.c_int if p.startswith("int") else p)
    return kinds


@pytest.mark.parametrize("source,name", [
    ("flash_attn_fwd.cu", "flash_attn_fwd"),
    ("flash_attn_bwd.cu", "flash_attn_bwd_dq"),
    ("flash_attn_bwd.cu", "flash_attn_bwd_dkv"),
])
def test_ctypes_signature_matches_the_c_entry_point(source, name):
    """ctypes passes what `_ARGTYPES` says: a pointer or stride given as a
    C int would be cut to 32 bits, and a missing argument shifts every one
    after it. Held to the parameter list in the source."""
    assert _ARGTYPES[name] == _c_argtypes(source, name)
