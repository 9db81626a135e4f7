// Serial CPU ongrid partition — the grounded performance baseline.
//
// The reference (adam-kerrigan/pybader) publishes no benchmark numbers, so
// the bench driver's vs_baseline ratio needs a measured anchor.  This is a
// clean-room serial implementation of the reference's ongrid kernel
// semantics (/root/reference/pybader/methods.py:15-219): per-voxel
// steepest-ascent path following with early-exit path compression — the
// same algorithm its numba-compiled kernel runs per thread — built with
// the same compiler class (LLVM there, GCC -O3 here).  bench.py times it
// on the bench host over a small grid and scales by an assumed thread
// count (bench.py REFERENCE_THREADS) to estimate the reference's 8-thread
// throughput.
//
// Exposed C ABI (ctypes; see bench.py:measured_baseline):
//   long so_partition(const double* rho, long nx, long ny, long nz,
//                     const double* w27, int* labels_out);
//   long so_partition_vac(..., const unsigned char* vac);
// returns the number of maxima found (labels_out gets 0-based basin ids in
// discovery order; vacuum voxels -1), or < 0 on error.  The vacuum variant
// mirrors the reference's skip rule (methods.py:73: pre-marked voxels are
// never walked; ascent never *enters* vacuum because vacuum is the low
// set), giving a workload comparable to the bench's vacuum-masked runs.

#include <cstdint>
#include <vector>

namespace {

// neighbour scan order: ix, iy, iz in (-1, 0, 1) — the tie-break order of
// the reference kernel (first strictly-greater wins; self wins all ties)
struct Off { int x, y, z; };

}  // namespace

extern "C" {

long so_partition_vac(const double* rho, long nx, long ny, long nz,
                      const double* w27, int* labels,
                      const unsigned char* vac) {
    if (nx <= 0 || ny <= 0 || nz <= 0) return -1;
    const long n = nx * ny * nz;
    Off offs[27];
    {
        int k = 0;
        for (int ix = -1; ix <= 1; ++ix)
            for (int iy = -1; iy <= 1; ++iy)
                for (int iz = -1; iz <= 1; ++iz)
                    offs[k++] = Off{ix, iy, iz};
    }
    for (long i = 0; i < n; ++i) labels[i] = -2;  // unassigned

    std::vector<long> path;
    path.reserve(1024);
    long n_max = 0;

    for (long start = 0; start < n; ++start) {
        if (labels[start] >= 0) continue;
        if (vac != nullptr && vac[start]) {
            labels[start] = -1;
            continue;
        }
        path.clear();
        long p = start;
        int label = -1;
        for (;;) {
            if (labels[p] >= 0) {  // early exit into an assigned voxel
                label = labels[p];
                break;
            }
            path.push_back(p);
            const long px = p / (ny * nz);
            const long py = (p / nz) % ny;
            const long pz = p % nz;
            const double rp = rho[p];
            double best = rp;
            long best_q = p;
            for (int k = 0; k < 27; ++k) {
                if (k == 13) continue;  // self
                long qx = px + offs[k].x;
                long qy = py + offs[k].y;
                long qz = pz + offs[k].z;
                if (qx < 0) qx += nx; else if (qx >= nx) qx -= nx;
                if (qy < 0) qy += ny; else if (qy >= ny) qy -= ny;
                if (qz < 0) qz += nz; else if (qz >= nz) qz -= nz;
                const long q = (qx * ny + qy) * nz + qz;
                const double val = (rho[q] - rp) * w27[k] + rp;
                if (val > best) {  // strict: first greater wins, self ties
                    best = val;
                    best_q = q;
                }
            }
            if (best_q == p) {  // local maximum: new basin
                label = static_cast<int>(n_max++);
                break;
            }
            p = best_q;
        }
        for (long v : path) labels[v] = label;  // path compression
    }
    return n_max;
}

long so_partition(const double* rho, long nx, long ny, long nz,
                  const double* w27, int* labels) {
    return so_partition_vac(rho, nx, ny, nz, w27, labels, nullptr);
}

}  // extern "C"
