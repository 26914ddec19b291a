"""ctypes binding for the native graph library (``native/graphworld.cpp``).

The port of ``curriculum_learning_for_vln_tpu/world/native.py``.  The C++
source at the root of the checkout is compiled by ``g++`` at first use
into ``build/native/`` (listed in ``.gitignore``) with the flags of
``native/Makefile``, so that its sums round as the JAX package's library
does (``-march=native`` lets g++ fuse multiply-adds).  The library is
named by a digest of the source, the flags and the target g++ resolves
``-march=native`` to, so a changed source, or a copy of the checkout on
a host of another CPU, builds anew; a build runs into a temporary file
and is renamed into place, so processes that build at once do not
clash.

* ``native_shortest_paths(graph)`` — C++ all-pairs Dijkstra, the world
  compiler's solver (``compile_world(use_native=True)``, the default);
  scipy's in ``graph.py`` is the fallback.
* ``GraphSim`` — the MatterSim-contract automaton (new_episode /
  make_action / get_state / navigable), a stand-in for the reference's
  external MatterSim build (ref: tasks/R2R-judy/src/utils/misc.py:346-390).

Without a C++ compiler ``native_available()`` is False,
``native_shortest_paths`` returns None and ``NativeWorld`` raises
ImportError.  This is host code: nothing here touches the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .graph import ScanGraph

SOURCE = Path(__file__).resolve().parents[2] / "native" / "graphworld.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-march=native", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None  # why the library did not build, once it failed

_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int)


def _cxx() -> str:
    return os.environ.get("CXX") or shutil.which("g++") or "g++"


def library_path() -> Path:
    """The library's path, named by a digest of the source, the flags and
    the compiler's resolved target options (one ``g++ -Q`` call, made once
    a process when the library is first loaded: a build directory copied
    to a host of another CPU must not hand it a library built for this
    one)."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    target = subprocess.run([_cxx(), "-march=native", "-Q", "--help=target"], check=True,
                            capture_output=True, text=True, timeout=60).stdout
    h.update(target.encode())
    return BUILD_DIR / f"graphworld-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if not out.exists():
        cxx = _cxx()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    lib.gw_world_create.restype = ctypes.c_void_p
    lib.gw_world_create.argtypes = [ctypes.c_int, ctypes.c_int, _F, _I, _I]
    lib.gw_world_destroy.argtypes = [ctypes.c_void_p]
    lib.gw_allpairs.argtypes = [ctypes.c_void_p, _F, _I]
    lib.gw_sim_create.restype = ctypes.c_void_p
    lib.gw_sim_create.argtypes = [ctypes.c_void_p]
    lib.gw_sim_destroy.argtypes = [ctypes.c_void_p]
    lib.gw_sim_new_episode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                                       ctypes.c_float]
    lib.gw_sim_make_action.restype = ctypes.c_int
    lib.gw_sim_make_action.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                                       ctypes.c_float]
    lib.gw_sim_get_state.argtypes = [ctypes.c_void_p, _I, _I, _F, _F]
    lib.gw_sim_navigable.restype = ctypes.c_int
    lib.gw_sim_navigable.argtypes = [ctypes.c_void_p, ctypes.c_int, _I, _F, _F]


def _load_library() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is None and _build_error is None:
            try:
                lib = ctypes.CDLL(str(_build()))
                _declare(lib)
                _lib = lib
            except (OSError, subprocess.SubprocessError) as e:  # no compiler, or it failed
                _build_error = f"{type(e).__name__}: {e}"
        return _lib


def native_available() -> bool:
    return _load_library() is not None


def native_build_error() -> Optional[str]:
    """Why the library did not build, or None."""
    return _build_error


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


class NativeWorld:
    """One scan's graph uploaded into the native library."""

    def __init__(self, graph: ScanGraph):
        lib = _load_library()
        if lib is None:
            raise ImportError("the native graph library is unavailable (no C++ compiler?)")
        self._lib = lib
        self.graph = graph
        pos = np.ascontiguousarray(graph.pos, dtype=np.float32)
        ea = np.ascontiguousarray(graph.edges[:, 0], dtype=np.int32)
        eb = np.ascontiguousarray(graph.edges[:, 1], dtype=np.int32)
        self._handle = lib.gw_world_create(graph.num_nodes, len(graph.edges), _ptr(pos, _F),
                                           _ptr(ea, _I), _ptr(eb, _I))

    def allpairs(self) -> Tuple[np.ndarray, np.ndarray]:
        """(dist [V, V] f32, next_hop [V, V] int32), scan-local ids."""
        V = self.graph.num_nodes
        dist = np.empty((V, V), dtype=np.float32)
        nh = np.empty((V, V), dtype=np.int32)
        self._lib.gw_allpairs(self._handle, _ptr(dist, _F), _ptr(nh, _I))
        return dist, nh

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.gw_world_destroy(self._handle)
            self._handle = None


def native_shortest_paths(graph: ScanGraph) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """C++ all-pairs Dijkstra; None when the native library is unavailable."""
    if not native_available():
        return None
    return NativeWorld(graph).allpairs()


class GraphSim:
    """MatterSim-contract navigation automaton over a ``NativeWorld``.

    State: (node, viewIndex, heading, elevation) on the 30-degree view
    grid; ``navigable()`` returns (nodes, rel_heading, rel_elevation) for
    the current view, slot 0 being the current pose."""

    MAX_LOCS = 64

    def __init__(self, world: NativeWorld):
        self._lib = world._lib
        self._world = world  # keeps the graph alive
        self._handle = self._lib.gw_sim_create(world._handle)
        self._nodes = np.empty(self.MAX_LOCS, dtype=np.int32)
        self._rh = np.empty(self.MAX_LOCS, dtype=np.float32)
        self._re = np.empty(self.MAX_LOCS, dtype=np.float32)

    def new_episode(self, node: int, heading: float, elevation: float = 0.0) -> None:
        self._lib.gw_sim_new_episode(self._handle, int(node), float(heading), float(elevation))

    def make_action(self, index: int, heading_chg: float, elevation_chg: float) -> None:
        if self._lib.gw_sim_make_action(self._handle, int(index), float(heading_chg),
                                        float(elevation_chg)) != 0:
            raise IndexError(f"invalid navigable index {index}")

    def get_state(self) -> dict:
        node, view = ctypes.c_int(), ctypes.c_int()
        heading, elevation = ctypes.c_float(), ctypes.c_float()
        self._lib.gw_sim_get_state(self._handle, ctypes.byref(node), ctypes.byref(view),
                                   ctypes.byref(heading), ctypes.byref(elevation))
        return {"node": node.value, "viewIndex": view.value, "heading": heading.value,
                "elevation": elevation.value}

    def navigable(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        n = self._lib.gw_sim_navigable(self._handle, self.MAX_LOCS, _ptr(self._nodes, _I),
                                       _ptr(self._rh, _F), _ptr(self._re, _F))
        return self._nodes[:n].copy(), self._rh[:n].copy(), self._re[:n].copy()

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.gw_sim_destroy(self._handle)
            self._handle = None
