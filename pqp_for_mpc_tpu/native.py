"""ctypes bindings to the in-repo native (C++) components.

* ``libpqp_oracle.so`` — float32 conformance oracle (native/pqp_oracle.cpp):
  an independent single-threaded implementation of the PQP pipeline used to
  cross-check the JAX solver on random instances (the role the reference's
  ``PQP_CPU.c`` played for its GPU variants).
* ``libpqp_io.so`` — fast native parsers/writers for the two text formats
  plus the random-instance generator (native/pqp_io.cpp).

Libraries are built on demand with ``make -C native`` (g++ is part of the
toolchain); all entry points degrade gracefully (raise
:class:`NativeUnavailable`) if the toolchain is missing so the pure-JAX
paths keep working.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from functools import lru_cache

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(REPO_ROOT, "native")
BUILD_DIR = os.path.join(NATIVE_DIR, "build")


class NativeUnavailable(RuntimeError):
    pass


def _build():
    try:
        subprocess.run(["make", "-C", NATIVE_DIR, "-j2"], check=True,
                       capture_output=True, text=True)
    except (OSError, subprocess.CalledProcessError) as e:
        out = getattr(e, "stderr", "") or str(e)
        raise NativeUnavailable(f"native build failed: {out}") from e


@lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    path = os.path.join(BUILD_DIR, name)
    if not os.path.exists(path):
        _build()
    try:
        return ctypes.CDLL(path)
    except OSError as e:
        raise NativeUnavailable(str(e)) from e


_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")


def _oracle():
    lib = _lib("libpqp_oracle.so")
    if not getattr(lib, "_configured", False):
        lib.pqp_oracle_solve.restype = ctypes.c_int
        lib.pqp_oracle_solve.argtypes = [
            _f32p, _f32p, ctypes.c_float, _f32p, _f32p,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_long, ctypes.c_int, ctypes.c_int,
            _f32p, _f32p, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        lib.pqp_oracle_dualize.restype = None
        lib.pqp_oracle_dualize.argtypes = [
            _f32p, _f32p, ctypes.c_float, _f32p, _f32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_float,
            _f32p, _f32p, ctypes.POINTER(ctypes.c_float), _f32p,
        ]
        lib._configured = True
    return lib


def oracle_solve(qp_inv, fp, mp, gp, kp, *, erc=1e-6, eac=1e-6, eaj=1e-6,
                 erj=1e-6, theta_floor=5.0, y0=1000.0, max_iters=200_000,
                 strict=True, gap_comp=False):
    """Run the C++ float32 oracle on one dense instance.  ``strict``
    keeps the reference's weak-duality test ``Jp <= -Jd``
    (``SolverConfig.strict_weak_duality``); ``gap_comp`` certifies the
    complementarity gap ``Y'(Qd Y + Fd)``
    (``SolverConfig.gap_from_complementarity``).

    Returns dict with U, Y, iters, Jp, Jd, converged.
    """
    lib = _oracle()
    qp_inv = np.ascontiguousarray(qp_inv, np.float32)
    fp = np.ascontiguousarray(fp, np.float32)
    gp = np.ascontiguousarray(gp, np.float32)
    kp = np.ascontiguousarray(kp, np.float32)
    M = fp.shape[0]
    N = kp.shape[0]
    U = np.zeros(M, np.float32)
    Y = np.zeros(N, np.float32)
    iters = ctypes.c_long(0)
    jp = ctypes.c_float(0)
    jd = ctypes.c_float(0)
    rc = lib.pqp_oracle_solve(
        qp_inv, fp, float(mp), gp, kp, N, M,
        erc, eac, eaj, erj, theta_floor, y0, max_iters, int(strict), int(gap_comp),
        U, Y, ctypes.byref(iters), ctypes.byref(jp), ctypes.byref(jd))
    if rc < 0:
        raise RuntimeError("oracle: singular Qp_inv")
    return dict(U=U, Y=Y, iters=int(iters.value), Jp=float(jp.value),
                Jd=float(jd.value), converged=bool(rc == 1))


def oracle_dualize(qp_inv, fp, mp, gp, kp, theta_floor=5.0):
    """C++ dualization for unit tests: returns (Qd, Fd, Md, theta)."""
    lib = _oracle()
    qp_inv = np.ascontiguousarray(qp_inv, np.float32)
    fp = np.ascontiguousarray(fp, np.float32)
    gp = np.ascontiguousarray(gp, np.float32)
    kp = np.ascontiguousarray(kp, np.float32)
    M = fp.shape[0]
    N = kp.shape[0]
    Qd = np.zeros((N, N), np.float32)
    Fd = np.zeros(N, np.float32)
    Md = ctypes.c_float(0)
    theta = np.zeros(N, np.float32)
    lib.pqp_oracle_dualize(qp_inv, fp, float(mp), gp, kp, N, M, theta_floor,
                           Qd, Fd, ctypes.byref(Md), theta)
    return Qd, Fd, float(Md.value), theta


def _io():
    lib = _lib("libpqp_io.so")
    if not getattr(lib, "_configured", False):
        lib.pqp_io_read_matrix.restype = ctypes.c_int
        lib.pqp_io_read_matrix.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long, _f32p]
        lib.pqp_io_read_generated.restype = ctypes.c_int
        lib.pqp_io_generate.restype = None
        lib.pqp_io_generate.argtypes = [
            ctypes.c_long, ctypes.c_long, ctypes.c_uint64,
            _f32p, _f32p, ctypes.POINTER(ctypes.c_float), _f32p, _f32p]
        lib.pqp_io_write_generated.restype = ctypes.c_int
        lib.pqp_io_write_generated.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
            _f32p, _f32p, ctypes.c_float, _f32p, _f32p]
        lib._configured = True
    return lib


def native_write_generated(path: str, qdiag, fp, mp, kp, gp) -> None:
    lib = _io()
    rc = lib.pqp_io_write_generated(
        path.encode(),
        len(qdiag), len(kp),
        np.ascontiguousarray(qdiag, np.float32),
        np.ascontiguousarray(fp, np.float32), float(mp),
        np.ascontiguousarray(kp, np.float32),
        np.ascontiguousarray(gp, np.float32))
    if rc != 0:
        raise IOError(f"pqp_io_write_generated({path}) failed rc={rc}")


def native_read_matrix(path: str, rows: int, cols: int) -> np.ndarray:
    """Native fast path for example-format matrix files (same transposed
    semantics as the Python loader)."""
    lib = _io()
    out = np.zeros((rows, cols), np.float32)
    rc = lib.pqp_io_read_matrix(path.encode(), rows, cols, out)
    if rc != 0:
        raise IOError(f"pqp_io_read_matrix({path}) failed rc={rc}")
    return out


def native_generate(M: int, N: int, seed: int = 0):
    """Native random-instance generator (reference distributions)."""
    lib = _io()
    qdiag = np.zeros(M, np.float32)
    fp = np.zeros(M, np.float32)
    mp = ctypes.c_float(0)
    kp = np.zeros(N, np.float32)
    gp = np.zeros((N, M), np.float32)
    lib.pqp_io_generate(M, N, seed, qdiag, fp, ctypes.byref(mp), kp, gp)
    return qdiag, fp, float(mp.value), kp, gp


def available() -> bool:
    try:
        _oracle()
        _io()
        return True
    except NativeUnavailable:
        return False
