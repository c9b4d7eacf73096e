// The constants of a cluster visit, shared by the tensor-core visit and
// walk (visit_mma.cuh) of the cluster, stream and pair kernels: the table's
// shape (accel/clusters.py) and the Moller-Trumbore predicate's epsilons
// (constants.py), as their plain versions (ops/intersect_cluster.py) use
// them.

#pragma once

namespace visit {

constexpr int kClusterTris = 128;   // triangle slots per cluster
constexpr int kClusterCols = 512;   // feature columns per cluster (4 x 128)
constexpr int kFeatUsed = 10;       // feature rows that pair with the table
constexpr float kDetEps = 1e-9f;    // constants.DET_EPS
constexpr float kTMin = 1e-4f;      // constants.T_MIN
constexpr float kDenomFloor = 1e-30f;

}  // namespace visit
