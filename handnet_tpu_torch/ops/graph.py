"""Graph construction + Graclus/HEM coarsening for the Pose2Mesh GCN.

A copy of ``handnet_tpu/ops/graph.py`` (numpy and scipy, run once on the
host): build the mesh adjacency, coarsen it ``levels`` times with heavy-edge
matching, order nodes so that parent/child form a binary tree (fake nodes
padded), and produce the rescaled normalized Laplacians the Chebyshev
convolutions consume, as dense float32 arrays (the largest graph has about
1,150 nodes).

Reference behavior: pose2mesh/lib/graph_utils.py:37-99 (build_graph/build_adj/
build_coarse_graphs) and pose2mesh/lib/coarsening.py:6-280 (laplacian, HEM,
compute_perm, perm_adjacency), quirks included.

One difference: :func:`lmax` starts ARPACK from a fixed vector, so two
builds of one pyramid give the same bits (the JAX package's random start
moves the Laplacians by ~1e-6 from build to build). An exported artifact
and the pipeline it was exported from then agree bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg  # noqa: F401  (sp.linalg.eigsh)

# the 21-joint hand skeleton the pipeline's mesh head uses
# (handnet_tpu/models/pipeline.py:63-64): wrist to each finger base, then
# each finger's chain of 4
HAND_SKELETON = tuple((0, i) for i in (1, 5, 9, 13, 17)) + tuple(
    (i, i + 1) for i in range(1, 20) if i % 4 != 0)


def strip_faces(num_vertices: int = 778) -> np.ndarray:
    """The same-size stand-in for the licensed MANO triangulation: a strip
    of ``num_vertices - 2`` triangles ``(i, i+1, i+2)``
    (handnet_tpu/models/pipeline.py:60-62)."""
    i = np.arange(num_vertices - 2)
    return np.stack([i, i + 1, i + 2], axis=1)


def mesh_adjacency(faces: np.ndarray, num_vertices: int) -> sp.csr_matrix:
    """Binary symmetric adjacency from a triangle list (graph_utils.py:37-61)."""
    f = np.asarray(faces)
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [0, 2]]], axis=0)
    data = np.ones(len(edges), np.float32)
    adj = sp.coo_matrix((data, (edges[:, 0], edges[:, 1])),
                        shape=(num_vertices, num_vertices)).tocsr()
    adj.data[:] = 1.0  # collapse duplicate edges to weight 1
    adj = adj.maximum(adj.T)
    adj.setdiag(0)
    adj.eliminate_zeros()
    return adj


def joint_adjacency(num_joints: int, skeleton: Sequence[Tuple[int, int]],
                    extra_pairs: Sequence[Tuple[int, int]] = ()) -> np.ndarray:
    """Skeleton adjacency + self loops (graph_utils.py:64-74)."""
    adj = np.zeros((num_joints, num_joints), np.float32)
    for a, b in list(skeleton) + list(extra_pairs):
        adj[a, b] = 1.0
        adj[b, a] = 1.0
    return adj + np.eye(num_joints, dtype=np.float32)


def normalized_laplacian(W) -> sp.csr_matrix:
    """L = I - D^-1/2 W D^-1/2 (coarsening.py:6-25)."""
    W = sp.csr_matrix(W)
    d = np.asarray(W.sum(axis=0)).ravel()
    d = d + np.spacing(np.float32(0))
    d_inv_sqrt = 1.0 / np.sqrt(d)
    D = sp.diags(d_inv_sqrt)
    return (sp.identity(W.shape[0], dtype=W.dtype) - D @ W @ D).tocsr()


def lmax(L) -> float:
    """Largest-magnitude eigenvalue, by ARPACK from a fixed start vector."""
    v0 = np.random.default_rng(0).uniform(-1.0, 1.0, L.shape[0]).astype(L.dtype)
    return float(sp.linalg.eigsh(L, k=1, which="LM", v0=v0,
                                 return_eigenvectors=False)[0])


def rescale_laplacian(L, lmax_val: float) -> sp.csr_matrix:
    """Spectral rescale as the reference computes it: coarsening.py:31 reads
    ``L /= lmax * 2``, i.e. L/(2*lmax) - I, not the textbook 2L/lmax - I.
    Converted Pose2Mesh checkpoints were trained against this spectrum."""
    M = L.shape[0]
    return (L * (1.0 / (2.0 * lmax_val)) - sp.identity(M, dtype=L.dtype)
            ).tocsr()


def _hem_one_level(rr: np.ndarray, cc: np.ndarray, vv: np.ndarray,
                   rid: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """One heavy-edge-matching pass over a (row, col, val) triplet list whose
    ``rr`` axis is sorted ascending, in the reference's exact decision
    sequence (coarsening.py:153-211):

    * the per-row scan windows come from a running count that credits each
      row's first entry to the PREVIOUS row (coarsening.py:160-165), so row
      r scans one entry past its true extent and row r+1 starts one short;
    * the "diagonal" terms of the metric are ``vv[rowstart[.]]``, the first
      stored edge weight of the row, not W's diagonal (coarsening.py:184-186);
    * marked neighbors are skipped and ties keep the first-seen neighbor
      (strict ``>``).
    """
    nnz = len(rr)
    n = int(rr[nnz - 1]) + 1
    marked = np.zeros(n, bool)
    rowstart = np.zeros(n, np.int64)
    rowlength = np.zeros(n, np.int64)
    cluster_id = np.zeros(n, np.int32)

    prev_row, count = rr[0], 0
    for k in range(nnz):
        rowlength[count] += 1
        if rr[k] > prev_row:
            prev_row = rr[k]
            rowstart[count + 1] = k
            count += 1

    cluster_count = 0
    for tid in rid:
        if marked[tid]:
            continue
        marked[tid] = True
        rs = rowstart[tid]
        best, best_val = -1, 0.0
        for j in range(rowlength[tid]):
            nid = cc[rs + j]
            if marked[nid]:
                continue
            w_ij = vv[rs + j]
            w_ii = vv[rowstart[tid]]
            w_jj = vv[rowstart[nid]]
            val = (2.0 * w_ij + w_ii + w_jj) / (
                weights[tid] + weights[nid] + 1e-9)
            if val > best_val:
                best_val, best = val, nid
        cluster_id[tid] = cluster_count
        if best >= 0:
            cluster_id[best] = cluster_count
            marked[best] = True
        cluster_count += 1
    return cluster_id


def hem_coarsen(W: sp.csr_matrix, levels: int
                ) -> Tuple[List[sp.csr_matrix], List[np.ndarray]]:
    """Repeated HEM coarsening (coarsening.py:67-148): the visit order is
    ascending weighted degree (the reference's random permutation at
    coarsening.py:90 is overwritten at once); the pairing weights are
    degree minus diagonal at level 0 but the FULL degree at every coarser
    level (coarsening.py:96 vs :141)."""
    graphs = [W]
    parents = []
    degree = np.asarray(W.sum(axis=0)).ravel() - W.diagonal()
    for _ in range(levels):
        rid = np.argsort(np.asarray(W.sum(axis=0)).ravel())
        idx_row, idx_col, vals = sp.find(W)
        # the reference sorts by whichever triplet axis comes out ordered
        # (coarsening.py:115-121); W is symmetric, so either way the list
        # is row-sorted
        if not np.all(idx_row[:-1] <= idx_row[1:]):
            idx_row, idx_col = idx_col, idx_row
        cluster_id = _hem_one_level(idx_row, idx_col, vals, rid, degree)
        parents.append(cluster_id)
        n_new = int(cluster_id.max()) + 1
        W = sp.csr_matrix(
            (vals, (cluster_id[idx_col], cluster_id[idx_row])),
            shape=(n_new, n_new))
        W.eliminate_zeros()
        graphs.append(W)
        degree = np.asarray(W.sum(axis=0)).ravel()
    return graphs, parents


def binary_tree_perms(parents: List[np.ndarray]) -> List[np.ndarray]:
    """Node orderings per level so that children (i, i+1) pool to parent i//2;
    singletons and fakes are padded (coarsening.py:216-258 compute_perm)."""
    if not parents:
        return []
    indices = [list(range(int(parents[-1].max()) + 1))]
    for parent in parents[::-1]:
        pool_singletons = len(parent)
        layer = []
        for i in indices[-1]:
            nodes = list(np.where(parent == i)[0])
            assert 0 <= len(nodes) <= 2
            if len(nodes) == 1:
                nodes.append(pool_singletons)
                pool_singletons += 1
            elif len(nodes) == 0:
                nodes.extend([pool_singletons, pool_singletons + 1])
                pool_singletons += 2
            layer.extend(nodes)
        indices.append(layer)
    return [np.asarray(x) for x in indices[::-1]]


def permute_adjacency(A: sp.spmatrix, indices: np.ndarray) -> sp.csr_matrix:
    """Relabel nodes to ``indices`` order, adding isolated fake nodes
    (coarsening.py:264-287 perm_adjacency)."""
    m = A.shape[0]
    m_new = len(indices)
    A = A.tocoo()
    if m_new > m:
        A = sp.coo_matrix((A.data, (A.row, A.col)), shape=(m_new, m_new))
    old_to_new = np.zeros(m_new, np.int64)
    old_to_new[np.asarray(indices)] = np.arange(m_new)
    return sp.csr_matrix(
        (A.data, (old_to_new[A.row], old_to_new[A.col])),
        shape=(m_new, m_new))


def perm_index_reverse(indices: np.ndarray) -> np.ndarray:
    """result[original_vertex] = its position in the permuted (padded)
    order, so ``mesh_padded[perm_reverse[:V]]`` recovers the original vertex
    order (ros_demo.py:162)."""
    indices = np.asarray(indices)
    out = np.zeros(len(indices), np.int64)
    out[indices] = np.arange(len(indices))
    return out


@dataclass(frozen=True)
class GraphPyramid:
    """Everything the MeshNet needs, as dense arrays.

    laplacians: the permuted mesh pyramid, fine to coarse (laplacians[0] is
    the padded full mesh), with the coarsest level replaced by the JOINT
    graph's Laplacian (21 nodes), as build_coarse_graphs does
    (graph_utils.py:77-99).
    """

    laplacians: Tuple[np.ndarray, ...]
    perm: np.ndarray            # level-0 ordering (padded size)
    perm_reverse: np.ndarray    # original vertex -> padded position
    mesh_sizes: Tuple[int, ...]


def build_graph_pyramid(faces: np.ndarray, num_joints: int,
                        skeleton: Sequence[Tuple[int, int]],
                        extra_pairs: Sequence[Tuple[int, int]] = (),
                        levels: int = 6) -> GraphPyramid:
    """build_coarse_graphs (graph_utils.py:77-99): coarsen the mesh
    ``levels`` times, replace the coarsest Laplacian with the joint
    skeleton's, rescale the mesh levels by their lmax."""
    n_verts = int(np.asarray(faces).max()) + 1
    W = mesh_adjacency(faces, n_verts)
    graphs, parents = hem_coarsen(W, levels)
    perms = binary_tree_perms(parents)

    laplacians = []
    for i, A in enumerate(graphs):
        if i < len(perms):
            A = permute_adjacency(A, perms[i])
        A = A.tocsr()
        A.eliminate_zeros()
        laplacians.append(normalized_laplacian(A))

    joint_adj = sp.csr_matrix(joint_adjacency(num_joints, skeleton,
                                              extra_pairs))
    laplacians[-1] = normalized_laplacian(joint_adj)

    dense = []
    for i, L in enumerate(laplacians):
        # the reference's rescale loop runs `for i in range(levels)`
        # (graph_utils.py:91-94), so the substituted joint-graph Laplacian
        # (entry `levels`) stays UNRESCALED: checkpoints were trained so
        if i < levels:
            L = rescale_laplacian(L, lmax(L))
        dense.append(np.asarray(L.todense(), np.float32))

    return GraphPyramid(
        laplacians=tuple(dense),
        perm=np.asarray(perms[0]) if perms else np.arange(n_verts),
        perm_reverse=(perm_index_reverse(perms[0]) if perms
                      else np.arange(n_verts)),
        mesh_sizes=tuple(l.shape[0] for l in dense),
    )
