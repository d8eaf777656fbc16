"""Partitioned Boolean Quadratic Programming solver (paper §2.1, [9]) — the
port's own copy of ``repro.core.pbqp`` (numpy only). ``solve`` keeps the
reference's reduction order and tie-breaking, so both packages return the
same assignment for the same graph.

Primitive selection is modelled as a PBQP instance: each layer is a node with
a cost vector over primitives (``inf`` = inapplicable), each data-dependence
between layers is an edge with a cost matrix over (producer primitive,
consumer primitive) pairs — the data-layout-transformation times.

We implement the Hames-Scholz reduction solver:
  R0  — isolated node: pick argmin.
  RI  — degree-1 node: fold into neighbour's vector.
  RII — degree-2 node: fold into an edge between its two neighbours
        (parallel edges merge by matrix addition, so series-parallel
        graphs — chains, VGG/ResNet trunks, GoogLeNet inception diamonds —
        reduce exactly).
  RN  — heuristic for irreducible degree-≥3 nodes; when used the solution
        is flagged ``optimal=False``.

A brute-force oracle (`brute_force`) is provided for property tests.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

Node = Hashable


@dataclasses.dataclass
class Solution:
    assignment: Dict[Node, int]
    cost: float
    optimal: bool

    def labelled(self, graph: "PBQPGraph") -> Dict[Node, str]:
        return {n: graph.labels[n][i] if graph.labels.get(n) else str(i)
                for n, i in self.assignment.items()}


class PBQPGraph:
    """Undirected multigraph; parallel edges merge by addition."""

    def __init__(self) -> None:
        self.costs: Dict[Node, np.ndarray] = {}
        self.adj: Dict[Node, Dict[Node, np.ndarray]] = {}
        self.labels: Dict[Node, Optional[List[str]]] = {}

    # -- construction ------------------------------------------------------
    def add_node(self, n: Node, costs: np.ndarray, labels: Optional[Sequence[str]] = None) -> None:
        costs = np.asarray(costs, np.float64)
        if costs.ndim != 1:
            raise ValueError("node costs must be a vector")
        if n in self.costs:
            raise ValueError(f"duplicate node {n!r}")
        if not np.isfinite(costs).any():
            raise ValueError(f"node {n!r} has no applicable choice (all costs inf)")
        self.costs[n] = costs
        self.adj[n] = {}
        self.labels[n] = list(labels) if labels is not None else None

    def add_edge(self, u: Node, v: Node, matrix: np.ndarray) -> None:
        if u == v:
            # Self-loop: diagonal folds into the node vector.
            m = np.asarray(matrix, np.float64)
            self.costs[u] = self.costs[u] + np.diag(m)
            return
        m = np.asarray(matrix, np.float64)
        if m.shape != (len(self.costs[u]), len(self.costs[v])):
            raise ValueError(f"edge {u!r}-{v!r} matrix shape {m.shape} != "
                             f"({len(self.costs[u])}, {len(self.costs[v])})")
        if v in self.adj[u]:
            self.adj[u][v] = self.adj[u][v] + m
            self.adj[v][u] = self.adj[u][v].T
        else:
            self.adj[u][v] = m.copy()
            self.adj[v][u] = self.adj[u][v].T

    def copy(self) -> "PBQPGraph":
        g = PBQPGraph()
        g.costs = {n: c.copy() for n, c in self.costs.items()}
        g.adj = {n: {v: m.copy() for v, m in nb.items()} for n, nb in self.adj.items()}
        g.labels = {n: (list(l) if l else None) for n, l in self.labels.items()}
        return g

    @property
    def nodes(self) -> List[Node]:
        return list(self.costs)


def _remove_node(g: PBQPGraph, n: Node) -> None:
    for v in list(g.adj[n]):
        del g.adj[v][n]
    del g.adj[n]
    del g.costs[n]


def solve(graph: PBQPGraph) -> Solution:
    g = graph.copy()
    # Reduction stack entries:
    #   ("R0", node, None)
    #   ("RI", node, neighbour, backptr[sv] -> su)
    #   ("RII", node, (v, w), backptr[sv, sw] -> su)
    #   ("RN", node, chosen_index)
    stack: List[tuple] = []
    optimal = True

    # Degree-bucketed worklist: buckets[d] is an insertion-ordered set of the
    # nodes of current degree d, so picking the next reduction is O(1)
    # amortised instead of a scan over all remaining nodes per round.
    deg: Dict[Node, int] = {n: len(g.adj[n]) for n in g.costs}
    buckets: Dict[int, Dict[Node, None]] = {}
    for n, d in deg.items():
        buckets.setdefault(d, {})[n] = None

    def _requeue(n: Node) -> None:
        d = len(g.adj[n])
        if d == deg[n]:
            return
        b = buckets[deg[n]]
        del b[n]
        if not b:
            del buckets[deg[n]]
        deg[n] = d
        buckets.setdefault(d, {})[n] = None

    def _pop(n: Node) -> None:
        b = buckets[deg[n]]
        del b[n]
        if not b:
            del buckets[deg[n]]
        del deg[n]
        neighbours = list(g.adj[n])
        _remove_node(g, n)
        for v in neighbours:
            _requeue(v)

    def _take(d: int) -> Optional[Node]:
        b = buckets.get(d)
        return next(iter(b)) if b else None

    while g.costs:
        # Prefer the cheapest applicable reduction each round.
        n0 = _take(0)
        if n0 is not None:
            # Record the *reduced* vector: later folds only add to nodes
            # still present, so at removal time this vector is final.
            stack.append(("R0", n0, int(np.argmin(g.costs[n0])), None))
            _pop(n0)
            continue
        n1 = _take(1)
        if n1 is not None:
            (v, m), = g.adj[n1].items()
            # fold: cost_v[sv] += min_su cost_u[su] + m[su, sv]
            tot = g.costs[n1][:, None] + m          # (su, sv)
            back = np.argmin(tot, axis=0)
            g.costs[v] = g.costs[v] + tot[back, np.arange(tot.shape[1])]
            stack.append(("RI", n1, v, back))
            _pop(n1)
            continue
        n2 = _take(2)
        if n2 is not None:
            (v, mv), (w, mw) = g.adj[n2].items()
            # D[sv, sw] = min_su cost_u[su] + mv[su, sv] + mw[su, sw]
            tot = (g.costs[n2][:, None, None] + mv[:, :, None] + mw[:, None, :])
            back = np.argmin(tot, axis=0)           # (sv, sw)
            d = np.min(tot, axis=0)
            stack.append(("RII", n2, (v, w), back))
            _pop(n2)
            # merge with existing v-w edge if any (parallel-edge addition)
            if w in g.adj[v]:
                g.adj[v][w] = g.adj[v][w] + d
                g.adj[w][v] = g.adj[v][w].T
            else:
                g.adj[v][w] = d
                g.adj[w][v] = d.T
            _requeue(v)
            _requeue(w)
            continue
        # RN heuristic: pick max-degree node, choose the selection that
        # minimises node cost + sum of row minima over incident edges, then
        # fold the chosen row into each neighbour's vector.
        optimal = False
        n = next(iter(buckets[max(buckets)]))
        score = g.costs[n].copy()
        for v, m in g.adj[n].items():
            score = score + np.min(m + g.costs[v][None, :], axis=1)
        su = int(np.argmin(score))
        for v, m in list(g.adj[n].items()):
            g.costs[v] = g.costs[v] + m[su]
        stack.append(("RN", n, su, None))
        _pop(n)

    # Back-substitution in reverse reduction order.
    assignment: Dict[Node, int] = {}
    for kind, n, aux, back in reversed(stack):
        if kind == "R0":
            assignment[n] = aux
        elif kind == "RI":
            assignment[n] = int(back[assignment[aux]])
        elif kind == "RII":
            v, w = aux
            assignment[n] = int(back[assignment[v], assignment[w]])
        elif kind == "RN":
            assignment[n] = int(aux)

    return Solution(assignment, evaluate(graph, assignment), optimal)


def evaluate(graph: PBQPGraph, assignment: Dict[Node, int]) -> float:
    cost = 0.0
    for n, c in graph.costs.items():
        cost += c[assignment[n]]
    seen = set()
    for u, nb in graph.adj.items():
        for v, m in nb.items():
            if (v, u) in seen:
                continue
            seen.add((u, v))
            cost += m[assignment[u], assignment[v]]
    return float(cost)


def brute_force(graph: PBQPGraph) -> Solution:
    nodes = graph.nodes
    best_cost, best_asg = np.inf, None
    for combo in itertools.product(*(range(len(graph.costs[n])) for n in nodes)):
        asg = dict(zip(nodes, combo))
        c = evaluate(graph, asg)
        if c < best_cost:
            best_cost, best_asg = c, asg
    return Solution(best_asg, float(best_cost), True)
