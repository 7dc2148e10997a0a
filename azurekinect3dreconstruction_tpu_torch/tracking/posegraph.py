"""SE(3) pose graph with Levenberg-Marquardt optimization and positional
loop-closure candidates (the counterpart of the JAX package's
``tracking/posegraph.py``, host numpy/scipy float64 as there).

Graphs are O(100s) of nodes, so the solver runs dense on the host (a 6N x 6N
solve is microseconds at this size); Jacobians are analytic first-order
(right perturbation) with Huber-weighted loop edges and a prune pass
mirroring Open3D's ``edge_prune_threshold``. Graphs persist as JSON in the
JAX package's format, so either package reads the other's.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation


@dataclasses.dataclass
class PoseGraphEdge:
    source: int
    target: int
    transformation: np.ndarray  # T_source_target measurement: X_s = T @ X_t
    information: np.ndarray = None  # 6x6
    uncertain: bool = False  # True for loop closures (Open3D convention)

    def __post_init__(self):
        self.transformation = np.asarray(self.transformation, np.float64)
        if self.information is None:
            self.information = np.eye(6)
        self.information = np.asarray(self.information, np.float64)


class PoseGraph:
    """nodes[i] = T_world_node (camera-to-world), edges with relative
    measurements; edge (s, t) stores the transform mapping target-node
    coordinates into source-node coordinates (Open3D's convention)."""

    def __init__(self):
        self.nodes: List[np.ndarray] = []
        self.edges: List[PoseGraphEdge] = []

    def add_node(self, T_world_node) -> int:
        self.nodes.append(np.asarray(T_world_node, np.float64))
        return len(self.nodes) - 1

    def add_edge(self, source: int, target: int, transformation,
                 information=None, uncertain: bool = False) -> None:
        self.edges.append(PoseGraphEdge(source, target, transformation, information, uncertain))

    def to_json(self) -> str:
        return json.dumps({
            "nodes": [n.tolist() for n in self.nodes],
            "edges": [{"source": e.source, "target": e.target,
                       "transformation": e.transformation.tolist(),
                       "information": e.information.tolist(), "uncertain": e.uncertain}
                      for e in self.edges],
        })

    @staticmethod
    def from_json(s: str) -> "PoseGraph":
        d = json.loads(s)
        g = PoseGraph()
        for n in d["nodes"]:
            g.add_node(np.asarray(n))
        for e in d["edges"]:
            g.add_edge(e["source"], e["target"], np.asarray(e["transformation"]),
                       np.asarray(e["information"]), e["uncertain"])
        return g

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path: str) -> "PoseGraph":
        with open(path) as f:
            return PoseGraph.from_json(f.read())


def _hat(w):
    return np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])


def _log(T):
    """float64 SE(3) log."""
    T = np.asarray(T, np.float64)
    w = Rotation.from_matrix(T[:3, :3]).as_rotvec()
    th2 = float(w @ w)
    W = _hat(w)
    if th2 > 1e-10:
        th = np.sqrt(th2)
        A = np.sin(th) / th
        B = (1 - np.cos(th)) / th2
        coef = (1 - A / (2 * B)) / th2
    else:
        coef = 1.0 / 12.0
    Vinv = np.eye(3) - 0.5 * W + coef * (W @ W)
    return np.concatenate([Vinv @ T[:3, 3], w])


def _exp(xi):
    """float64 SE(3) exp."""
    xi = np.asarray(xi, np.float64)
    v, w = xi[:3], xi[3:]
    th2 = float(w @ w)
    W = _hat(w)
    if th2 > 1e-10:
        th = np.sqrt(th2)
        B = (1 - np.cos(th)) / th2
        C = (th - np.sin(th)) / (th2 * th)
    else:
        B, C = 0.5, 1.0 / 6.0
    V = np.eye(3) + B * W + C * (W @ W)
    T = np.eye(4)
    T[:3, :3] = Rotation.from_rotvec(w).as_matrix()
    T[:3, 3] = V @ v
    return T


def _adjoint(T):
    R = T[:3, :3]
    A = np.zeros((6, 6))
    A[:3, :3] = R
    A[:3, 3:] = _hat(T[:3, 3]) @ R
    A[3:, 3:] = R
    return A


def _edge_residual(nodes, e: PoseGraphEdge):
    """e_res = log(T_meas^-1 @ T_s^-1 @ T_t), with first-order Jacobians
    with respect to right-perturbed node poses (T exp(x)): J_t = I and
    J_s = -Ad(T_t^-1 T_s)."""
    Ts, Tt = nodes[e.source], nodes[e.target]
    M = np.linalg.inv(e.transformation) @ np.linalg.inv(Ts) @ Tt
    return _log(M), -_adjoint(np.linalg.inv(Tt) @ Ts), np.eye(6)


def optimize(graph: PoseGraph, max_iterations: int = 30, edge_prune_threshold: float = 0.25,
             preference_loop_closure: float = 2.0, huber_delta: float = 0.1,
             verbose: bool = False) -> PoseGraph:
    """Levenberg-Marquardt over all nodes (node 0 fixed), Huber-weighted
    uncertain edges, followed by a prune of diverged loop closures (Open3D's
    ``GlobalOptimizationLevenbergMarquardt`` analog)."""
    nodes = [n.copy() for n in graph.nodes]
    n = len(nodes)
    if n <= 1 or not graph.edges:
        return graph

    def _edge_weight(e, r):
        w = preference_loop_closure if e.uncertain else 1.0
        if e.uncertain:  # Huber on loop closures only (odometry edges are trusted)
            nr = np.linalg.norm(r)
            if nr > huber_delta:
                w *= huber_delta / nr
        return w

    def _robust_cost(cur_nodes):
        c = 0.0
        for e in graph.edges:
            r, _, _ = _edge_residual(cur_nodes, e)
            c += float(_edge_weight(e, r) * (r @ e.information @ r))
        return c

    lam = 1e-4
    last_cost = np.inf
    for it in range(max_iterations):
        H = np.zeros((6 * n, 6 * n))
        b = np.zeros(6 * n)
        cost = 0.0
        for e in graph.edges:
            r, J_s, J_t = _edge_residual(nodes, e)
            info = _edge_weight(e, r) * e.information
            cost += float(r @ info @ r)
            s6, t6 = 6 * e.source, 6 * e.target
            H[s6:s6 + 6, s6:s6 + 6] += J_s.T @ info @ J_s
            H[t6:t6 + 6, t6:t6 + 6] += J_t.T @ info @ J_t
            H[s6:s6 + 6, t6:t6 + 6] += J_s.T @ info @ J_t
            H[t6:t6 + 6, s6:s6 + 6] += J_t.T @ info @ J_s
            b[s6:s6 + 6] += J_s.T @ info @ r
            b[t6:t6 + 6] += J_t.T @ info @ r

        H = H[6:, 6:]  # gauge fix: node 0
        b = b[6:]
        try:
            delta = np.linalg.solve(H + lam * np.diag(np.diag(H) + 1e-12), -b)
        except np.linalg.LinAlgError:
            break
        if not np.all(np.isfinite(delta)):
            break
        new_nodes = [nodes[0]] + [nodes[i] @ _exp(delta[6 * (i - 1): 6 * i])
                                  for i in range(1, n)]
        # the candidate is judged by the same robust objective as ``cost``
        new_cost = _robust_cost(new_nodes)
        if new_cost < cost:
            nodes = new_nodes
            lam = max(lam * 0.5, 1e-9)
            if verbose:
                print(f"[posegraph] iter {it}: cost {cost:.6f} -> {new_cost:.6f}")
            if abs(last_cost - new_cost) < 1e-12:
                break
            last_cost = new_cost
        else:
            lam *= 4.0
            if lam > 1e6:
                break

    out = PoseGraph()
    out.nodes = nodes
    for e in graph.edges:  # prune diverged loop closures
        if e.uncertain:
            r, _, _ = _edge_residual(nodes, e)
            if np.linalg.norm(r) > edge_prune_threshold:
                continue
        out.edges.append(e)
    return out


def find_loop_closures(positions, radius: float = 0.5, min_gap: int = 20,
                       exclude: Optional[set] = None) -> List[Tuple[int, int]]:
    """Positional loop-closure candidates: ``|p_i - p_j| < radius`` with
    ``i < j - min_gap``, sorted by distance (closest first): callers bound
    the verified attempts per check, and the nearest revisits are the pairs
    whose views overlap enough to verify."""
    pos = np.asarray(positions)
    out = []
    exclude = exclude or set()
    for j in range(len(pos)):
        for i in range(0, j - min_gap):
            if (i, j) in exclude:
                continue
            d = np.linalg.norm(pos[j] - pos[i])
            if d < radius:
                out.append((d, i, j))
    return [(i, j) for _, i, j in sorted(out)]
