// Serial CPU neargrid partition + refinement — grounds the DEFAULT-workload
// baseline (serial_baseline.cpp grounds the ongrid headline).
//
// Clean-room serial implementation of the reference's default method chain
// (/root/reference/pybader/methods.py:222-611 neargrid initial pass with
// label adoption and known-marking; refinement.py:16-508 +
// thread_handlers.py:128-236 'changed'-mode edge refinement), written from
// the same spec as the repo's numpy oracle (tests/oracle.py:255-518) — the
// two are label-parity-checked by tests/test_serial_native.py.
// chip_smoke.py compares the device pipeline's labels with it at 256^3.
//
// Exposed C ABI (ctypes):
//   long sn_neargrid(const double* rho, long nx, long ny, long nz,
//                    const double* w27, const double* tgrad /*3x3 row-major*/,
//                    int* labels_out);
//     -> number of maxima (labels 0-based discovery order), < 0 on error.
//   long sn_refine(const double* rho, long nx, long ny, long nz,
//                  const double* w27, const double* tgrad,
//                  int* labels /*inout*/, long iters /*<0 = converge*/);
//     -> total changed count ('changed' mode), < 0 on error.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct V3 { long x, y, z; };

struct Grid {
    const double* rho;
    long nx, ny, nz, n;
    const double* w27;
    const double* tg;  // row-major 3x3

    long wrap(long v, long lim) const {
        if (v < 0) return v + lim;
        if (v >= lim) return v - lim;
        return v;
    }
    long flat(long x, long y, long z) const { return (x * ny + y) * nz + z; }
    V3 unflat(long p) const {
        return V3{p / (ny * nz), (p / nz) % ny, p % nz};
    }

    // best ascent neighbour (first strictly-greater weighted value in scan
    // order wins; self wins all ties) — semantics of tests/oracle.py:41-58
    long ongrid_step(long p) const {
        const V3 v = unflat(p);
        const double rp = rho[p];
        double best = rp;
        long best_q = p;
        int k = 0;
        for (int ix = -1; ix <= 1; ++ix)
            for (int iy = -1; iy <= 1; ++iy)
                for (int iz = -1; iz <= 1; ++iz, ++k) {
                    if (ix == 0 && iy == 0 && iz == 0) continue;
                    const long q = flat(wrap(v.x + ix, nx), wrap(v.y + iy, ny),
                                        wrap(v.z + iz, nz));
                    const double val = (rho[q] - rp) * w27[k] + rp;
                    if (val > best) { best = val; best_q = q; }
                }
        return best_q;
    }

    // central-difference gradient in the t_grad frame; strict selects the
    // refinement-flavour axis-flat test (oracle.py:166-216 / :437-459)
    void grad_dir(long p, bool strict, double gd[3]) const {
        const V3 v = unflat(p);
        const double rp = rho[p];
        double g[3];
        const long up[3] = {flat(wrap(v.x + 1, nx), v.y, v.z),
                            flat(v.x, wrap(v.y + 1, ny), v.z),
                            flat(v.x, v.y, wrap(v.z + 1, nz))};
        const long dn[3] = {flat(wrap(v.x - 1, nx), v.y, v.z),
                            flat(v.x, wrap(v.y - 1, ny), v.z),
                            flat(v.x, v.y, wrap(v.z - 1, nz))};
        for (int j = 0; j < 3; ++j) {
            const double ru = rho[up[j]], rd = rho[dn[j]];
            const bool flat_axis = strict ? (ru < rp && rd < rp)
                                          : (ru <= rp && rd <= rp);
            g[j] = flat_axis ? 0.0 : (ru - rd) * 0.5;
        }
        for (int i = 0; i < 3; ++i)
            gd[i] = tg[3 * i] * g[0] + tg[3 * i + 1] * g[1]
                  + tg[3 * i + 2] * g[2];
    }
};

inline long round_away(double x) {
    return static_cast<long>(std::trunc(x + (x > 0 ? 0.5 : -0.5)));
}

// one neargrid step from pos given the running dr correction; returns the
// proposed next voxel, or pos itself when the gradient is ~zero
inline long neargrid_step(const Grid& G, long pos, double dr[3],
                          bool strict, bool* grad_zero) {
    double gd[3];
    G.grad_dir(pos, strict, gd);
    const double mg = std::fmax(std::fmax(std::fabs(gd[0]), std::fabs(gd[1])),
                                std::fabs(gd[2]));
    if (mg < 1e-14) { *grad_zero = true; return pos; }
    *grad_zero = false;
    const V3 v = G.unflat(pos);
    long nxt[3] = {v.x, v.y, v.z};
    const long dims[3] = {G.nx, G.ny, G.nz};
    for (int d = 0; d < 3; ++d) {
        const double g = gd[d] / mg;
        const long step = round_away(g);
        dr[d] += g - step;
        const long corr = round_away(dr[d]);
        dr[d] -= corr;
        nxt[d] = G.wrap(G.wrap(nxt[d] + step + corr, dims[d]), dims[d]);
    }
    return G.flat(nxt[0], nxt[1], nxt[2]);
}

}  // namespace

extern "C" {

// Reference neargrid initial pass, threads=1 semantics (order-dependent
// label adoption + known interior marking; spec tests/oracle.py:255-362).
long sn_neargrid(const double* rho, long nx, long ny, long nz,
                 const double* w27, const double* tgrad, int* volumes) {
    if (nx <= 0 || ny <= 0 || nz <= 0) return -1;
    Grid G{rho, nx, ny, nz, nx * ny * nz, w27, tgrad};
    const long n = G.n;
    std::vector<int8_t> known(n, 0);
    for (long i = 0; i < n; ++i) volumes[i] = 0;  // 0 == unassigned
    long n_max = 0;
    std::vector<long> path;
    path.reserve(4096);

    // interior mark: assigned voxel whose six NON-WRAPPED axis neighbours
    // share its label becomes known==2 (window-bounds quirk: boundary
    // voxels never qualify — oracle.py:278-297)
    auto interior_mark = [&](long pv) {
        const int vol = volumes[pv];
        if (vol < 1) return;
        const V3 v = G.unflat(pv);
        const long c[3] = {v.x, v.y, v.z};
        const long dims[3] = {nx, ny, nz};
        for (int h = 0; h < 3; ++h)
            for (int s = -1; s <= 1; s += 2) {
                const long q = c[h] + s;
                if (q < 0 || q >= dims[h]) return;
                long w[3] = {c[0], c[1], c[2]};
                w[h] = q;
                if (volumes[G.flat(w[0], w[1], w[2])] != vol) return;
            }
        known[pv] = 2;
    };

    for (long i = 0; i < n; ++i) {
        if (known[i] == 2) continue;
        known[i] = 1;
        path.clear();
        path.push_back(i);
        long pos = i;
        double dr[3] = {0, 0, 0};
        long final_v = -1;
        int vol_num = -1;
        for (;;) {
            bool gz = false;
            long nxt = neargrid_step(G, pos, dr, /*strict=*/false, &gz);
            if (known[nxt] == 1) {  // revisit of this path (or grad-zero)
                dr[0] = dr[1] = dr[2] = 0;
                nxt = G.ongrid_step(pos);
                if (nxt == pos) {  // ongrid maximum
                    final_v = pos;
                    vol_num = volumes[pos];  // 0 => new basin
                    break;
                }
            }
            if (known[nxt] == 2) {
                final_v = nxt;
                vol_num = volumes[nxt];
                break;
            }
            path.push_back(nxt);
            known[nxt] = 1;
            pos = nxt;
        }
        if (vol_num == 0) {
            ++n_max;
            vol_num = static_cast<int>(n_max);  // 1-based during the scan
            (void)final_v;
        }
        for (long q : path) {
            volumes[q] = vol_num;
            if (known[q] != 2) known[q] = 0;
        }
        for (long q : path) {
            const V3 v = G.unflat(q);
            const long c[3] = {v.x, v.y, v.z};
            const long dims[3] = {nx, ny, nz};
            for (int h = 0; h < 3; ++h)
                for (int s = -1; s <= 1; s += 2) {
                    const long t = c[h] + s;
                    if (t < 0 || t >= dims[h]) continue;
                    long w[3] = {c[0], c[1], c[2]};
                    w[h] = t;
                    interior_mark(G.flat(w[0], w[1], w[2]));
                }
        }
    }
    for (long i = 0; i < n; ++i) volumes[i] -= 1;  // 0-based labels
    return n_max;
}

namespace {

// full-grid serial edge classification -> known (2 interior / -1 near /
// -2 edge; no vacuum here: bench fields carry none) — oracle.py:219-252
void edge_scan(const Grid& G, const int* labels, int8_t* known) {
    const long n = G.n;
    std::vector<uint8_t> edge(n, 0);
    for (long p = 0; p < n; ++p) {
        const V3 v = G.unflat(p);
        const int lab = labels[p];
        const double rp = G.rho[p];
        bool is_edge = false, is_max = true;
        for (int ix = -1; ix <= 1; ++ix)
            for (int iy = -1; iy <= 1; ++iy)
                for (int iz = -1; iz <= 1; ++iz) {
                    if (ix == 0 && iy == 0 && iz == 0) continue;
                    const long q = G.flat(G.wrap(v.x + ix, G.nx),
                                          G.wrap(v.y + iy, G.ny),
                                          G.wrap(v.z + iz, G.nz));
                    if (labels[q] != lab) is_edge = true;
                    if (G.rho[q] > rp) is_max = false;
                }
        edge[p] = is_edge && !is_max;
    }
    std::memset(known, 2, n);
    for (long p = 0; p < n; ++p) {
        if (!edge[p]) continue;
        const V3 v = G.unflat(p);
        for (int ix = -1; ix <= 1; ++ix)
            for (int iy = -1; iy <= 1; ++iy)
                for (int iz = -1; iz <= 1; ++iz) {
                    if (ix == 0 && iy == 0 && iz == 0) continue;
                    const long q = G.flat(G.wrap(v.x + ix, G.nx),
                                          G.wrap(v.y + iy, G.ny),
                                          G.wrap(v.z + iz, G.nz));
                    if (!edge[q]) known[q] = -1;
                }
    }
    for (long p = 0; p < n; ++p)
        if (edge[p]) known[p] = -2;
}

// serial 'changed'-mode re-scan in place (oracle.py:365-420, skip_vacuum
// irrelevant without vacuum)
void edge_check_scan(const Grid& G, const int* labels, int8_t* known) {
    const long n = G.n;
    for (long p = 0; p < n; ++p) {
        if (known[p] != -2) continue;
        const V3 v = G.unflat(p);
        for (int ex = -1; ex <= 1; ++ex)
            for (int ey = -1; ey <= 1; ++ey)
                for (int ez = -1; ez <= 1; ++ez) {
                    const long pe = G.flat(G.wrap(v.x + ex, G.nx),
                                           G.wrap(v.y + ey, G.ny),
                                           G.wrap(v.z + ez, G.nz));
                    const V3 ve = G.unflat(pe);
                    const int lab = labels[pe];
                    const double rp = G.rho[pe];
                    bool is_edge = false, is_max = true;
                    for (int ix = -1; ix <= 1; ++ix)
                        for (int iy = -1; iy <= 1; ++iy)
                            for (int iz = -1; iz <= 1; ++iz) {
                                if (ix == 0 && iy == 0 && iz == 0) continue;
                                const long q = G.flat(
                                    G.wrap(ve.x + ix, G.nx),
                                    G.wrap(ve.y + iy, G.ny),
                                    G.wrap(ve.z + iz, G.nz));
                                if (labels[q] != lab) is_edge = true;
                                if (G.rho[q] > rp) is_max = false;
                            }
                    if (!is_edge) {
                        known[pe] = -1;
                    } else if (!is_max && known[pe] != -3) {
                        known[pe] = -3;
                        for (int ix = -1; ix <= 1; ++ix)
                            for (int iy = -1; iy <= 1; ++iy)
                                for (int iz = -1; iz <= 1; ++iz) {
                                    if (ix == 0 && iy == 0 && iz == 0)
                                        continue;
                                    const long q = G.flat(
                                        G.wrap(ve.x + ix, G.nx),
                                        G.wrap(ve.y + iy, G.ny),
                                        G.wrap(ve.z + iz, G.nz));
                                    if (known[q] >= 0) known[q] = -1;
                                }
                    }
                }
    }
    for (long p = 0; p < n; ++p)
        if (known[p] == -3) known[p] = -2;
}

}  // namespace

long sn_refine(const double* rho, long nx, long ny, long nz,
               const double* w27, const double* tgrad, int* labels,
               long iters) {
    if (nx <= 0 || ny <= 0 || nz <= 0) return -1;
    Grid G{rho, nx, ny, nz, nx * ny * nz, w27, tgrad};
    const long n = G.n;
    std::vector<int8_t> known(n);
    edge_scan(G, labels, known.data());
    // path-revisit stamps: stamp[v] == walk id marks membership of the
    // current walk's path (oracle refine_walk's on_path set)
    std::vector<int32_t> stamp(n, -1);
    std::vector<std::pair<long, int>> updates;
    long total_changed = 0;
    int32_t walk_id = 0;
    long it = 0;
    while (iters < 0 || it < iters) {
        ++it;
        if (it > 1) edge_check_scan(G, labels, known.data());
        updates.clear();
        long n_edges = 0;
        for (long p = 0; p < n; ++p) {
            if (known[p] != -2) continue;
            ++n_edges;
            ++walk_id;
            stamp[p] = walk_id;
            long pos = p;
            double dr[3] = {0, 0, 0};
            long term = -1;
            for (;;) {
                bool gz = false;
                long nxt = neargrid_step(G, pos, dr, /*strict=*/true, &gz);
                if (stamp[nxt] == walk_id) {  // grad-zero lands on pos too
                    dr[0] = dr[1] = dr[2] = 0;
                    nxt = G.ongrid_step(pos);
                    if (nxt == pos) { term = pos; break; }
                }
                if (known[nxt] == 2) { term = nxt; break; }
                stamp[nxt] = walk_id;
                pos = nxt;
            }
            const int new_lab = labels[term];
            if (new_lab != labels[p]) updates.emplace_back(p, new_lab);
            else known[p] = -1;  // unchanged edges leave the changed set
        }
        if (n_edges == 0) break;
        for (const auto& u : updates) labels[u.first] = u.second;
        total_changed += static_cast<long>(updates.size());
        if (updates.empty()) break;
    }
    return total_changed;
}

}  // extern "C"
