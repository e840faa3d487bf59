"""ctypes binding of the Mamba-2 single-token state update CUDA kernel.

The kernel (``csrc/ssm_state_update.cu``) replaces no Pallas kernel: the
reference's decode update (``repro.models.ssm.ssm_decode_step``) is plain
``jnp``. It decays, updates and reads the float32 SSM state of every row
that ``keep`` marks, in place and in one pass, and leaves the other rows'
state untouched. ``ssm_state_update`` checks its tensors, allocates the
output with ``torch.empty``, launches on the current CUDA stream, raises
if the launch was refused, and counts the launch in ``build.launches``.
The library builds at the first launch (see ``build.py``). Shapes and
semantics are those of ``ref.ssm_state_update_ref``. ``keep`` is read on
the device, so a CUDA graph may capture the call.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: state widths N the kernel takes: N / 4 lanes hold a row of the slab
STATE_WIDTHS = (4, 8, 16, 32, 64, 128)
#: the most 16-byte vectors (hp * N / 4) one (row, head) slab may hold
MAX_VECTORS = 2048
_lib = None


def _library():
    global _lib
    if _lib is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        _lib = build.bind("ssm_state_update", {
            "ssm_state_update_launch": [ptr] * 9 + [i32] * 4 + [ptr]})
    return _lib


def ssm_state_update(state, x, dt, A, Bm, Cm, D, keep):
    """Launch the kernel. state: (B,nh,hp,N) float32, updated in place
    (a layer's view of a stacked cache is taken as it is); x: (B,nh,hp);
    dt: (B,nh) post-softplus; A: (nh,) negative; Bm/Cm: (B,N); D: (nh,);
    all float32; keep: (B,) bool. Returns y (B,nh,hp) float32, 0 on rows
    where keep is False."""
    # the state, B and C are read as 16-byte vectors; the rest one at a time
    build.check_on_card(state.device, state=state, Bm=Bm, Cm=Cm)
    build.check_on_card(state.device, align=4, x=x, dt=dt, A=A, D=D)
    build.check_on_card(state.device, align=1, keep=keep)
    f32 = [n for n, t in (("state", state), ("x", x), ("dt", dt), ("A", A),
                          ("Bm", Bm), ("Cm", Cm), ("D", D))
           if t.dtype != torch.float32]
    if f32:
        raise TypeError(f"{', '.join(f32)} must be float32")
    if keep.dtype != torch.bool:
        raise TypeError(f"keep must be bool, not {keep.dtype}")
    if state.dim() != 4:
        raise ValueError(f"state must be (B,nh,hp,N), not {tuple(state.shape)}")
    B, nh, hp, N = state.shape
    if (x.shape != (B, nh, hp) or dt.shape != (B, nh) or A.shape != (nh,)
            or Bm.shape != (B, N) or Cm.shape != (B, N) or D.shape != (nh,)
            or keep.shape != (B,)):
        raise ValueError("inconsistent shapes: state %s, x %s, dt %s, A %s, "
                         "Bm %s, Cm %s, D %s, keep %s" % tuple(
                             tuple(t.shape) for t in (state, x, dt, A, Bm, Cm,
                                                      D, keep)))
    if N not in STATE_WIDTHS or hp * N // 4 > MAX_VECTORS or B > 65535:
        raise ValueError(f"state width {N} (one of {STATE_WIDTHS}), head_dim "
                         f"{hp} (hp * N / 4 at most {MAX_VECTORS}) or {B} "
                         f"rows (at most 65535) not supported")
    y = torch.empty((B, nh, hp), dtype=torch.float32, device=state.device)
    lib = _library()
    stream = torch.cuda.current_stream(state.device).cuda_stream
    err = lib.ssm_state_update_launch(
        state.data_ptr(), x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(), keep.data_ptr(),
        y.data_ptr(), B, nh, hp, N, stream)
    build.raise_on(err, "ssm_state_update")
    build.launches["ssm_state_update"] += 1
    return y
