// Host-side native helpers for the stereo engine (the filters and the
// rasterizer are a copy of stereovision_tpu/csrc/svtpu_host.cpp's, kept in
// the PyTorch port so that it never imports the JAX package; the span coder
// is the port's own).
//
// The device owns all dense pixel work; these routines cover the tiny
// irregular host stage between the two device stages:
//   * sequential in-place support-point filters, reproducing the exact
//     cascade semantics of the reference's serial implementation
//     (removeInconsistentSupportPoints / removeRedundantSupportPoints,
//     src/serial_includes/elas/elas.cpp:152-233 — results depend on the
//     u-major, v-minor in-place scan order, so a data-parallel snapshot
//     formulation is NOT equivalent; this must stay sequential and
//     therefore lives on the host),
//   * the scanline triangle-id rasterizer with the reference's exact
//     pixel-visit semantics (computeDisparity triangle loop,
//     elas.cpp:839-941: corners sorted ascending in u, spans between the
//     AC line and AB/BC lines, lower bound inclusive / upper exclusive,
//     later triangles overwrite earlier ones),
//   * the triangle-id span code (the port's own: the format of
//     stereovision_tpu_torch/hostlib/geometry.py:encode_tri_spans, byte for
//     byte, read straight off the rasterizer's map).
//
// Built as a plain C ABI shared library, loaded with ctypes
// (stereovision_tpu_torch/hostlib/raster.py).  No Python headers needed.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Sequential support filters (in-place on the (hc, wc) int16 candidate grid)

void sv_remove_inconsistent(int16_t* D, int hc, int wc, int window,
                            int threshold, int min_support) {
    for (int u = 0; u < wc; ++u) {
        for (int v = 0; v < hc; ++v) {
            int16_t d = D[v * wc + u];
            if (d < 0) continue;
            int support = 0;
            for (int u2 = u - window; u2 <= u + window; ++u2) {
                if (u2 < 0 || u2 >= wc) continue;
                for (int v2 = v - window; v2 <= v + window; ++v2) {
                    if (v2 < 0 || v2 >= hc) continue;
                    int16_t d2 = D[v2 * wc + u2];
                    if (d2 >= 0 && std::abs(d - d2) <= threshold) ++support;
                }
            }
            if (support < min_support) D[v * wc + u] = -1;
        }
    }
}

void sv_remove_redundant(int16_t* D, int hc, int wc, int max_dist,
                         int threshold, int vertical) {
    const int du[2] = {vertical ? 0 : -1, vertical ? 0 : 1};
    const int dv[2] = {vertical ? -1 : 0, vertical ? 1 : 0};
    for (int u = 0; u < wc; ++u) {
        for (int v = 0; v < hc; ++v) {
            int16_t d = D[v * wc + u];
            if (d < 0) continue;
            bool redundant = true;
            for (int i = 0; i < 2 && redundant; ++i) {
                bool support = false;
                int u2 = u, v2 = v;
                for (int j = 0; j < max_dist; ++j) {
                    u2 += du[i];
                    v2 += dv[i];
                    if (u2 < 0 || v2 < 0 || u2 >= wc || v2 >= hc) break;
                    int16_t d2 = D[v2 * wc + u2];
                    if (d2 >= 0 && std::abs(d - d2) <= threshold) {
                        support = true;
                        break;
                    }
                }
                if (!support) redundant = false;
            }
            if (redundant) D[v * wc + u] = -1;
        }
    }
}

void sv_filter_support(int16_t* D, int hc, int wc, int incon_window,
                       int incon_threshold, int incon_min_support,
                       int redun_max_dist, int redun_threshold) {
    sv_remove_inconsistent(D, hc, wc, incon_window, incon_threshold,
                           incon_min_support);
    sv_remove_redundant(D, hc, wc, redun_max_dist, redun_threshold, 1);
    sv_remove_redundant(D, hc, wc, redun_max_dist, redun_threshold, 0);
}

// ---------------------------------------------------------------------------
// Scanline triangle-id rasterizer

void sv_rasterize(const int32_t* tris, int num_tris, const float* pu,
                  const float* pv, int width, int height, int32_t* tri_id) {
    for (long i = 0; i < (long)width * height; ++i) tri_id[i] = -1;

    for (int t = 0; t < num_tris; ++t) {
        float tu[3] = {pu[tris[3 * t]], pu[tris[3 * t + 1]],
                       pu[tris[3 * t + 2]]};
        float tv[3] = {pv[tris[3 * t]], pv[tris[3 * t + 1]],
                       pv[tris[3 * t + 2]]};
        // sort corners ascending in u (stable insertion, strict compare)
        for (int j = 0; j < 3; ++j)
            for (int k = 0; k < j; ++k)
                if (tu[k] > tu[j]) {
                    std::swap(tu[j], tu[k]);
                    std::swap(tv[j], tv[k]);
                }
        const float A_u = tu[0], A_v = tv[0];
        const float B_u = tu[1], B_v = tv[1];
        const float C_u = tu[2], C_v = tv[2];
        float AB_a = 0.f, AC_a = 0.f, BC_a = 0.f;
        if ((int)A_u != (int)B_u) AB_a = (A_v - B_v) / (A_u - B_u);
        if ((int)A_u != (int)C_u) AC_a = (A_v - C_v) / (A_u - C_u);
        if ((int)B_u != (int)C_u) BC_a = (B_v - C_v) / (B_u - C_u);
        const float AB_b = A_v - AB_a * A_u;
        const float AC_b = A_v - AC_a * A_u;
        const float BC_b = B_v - BC_a * B_u;

        for (int part = 0; part < 2; ++part) {
            const float lo = part == 0 ? A_u : B_u;
            const float hi = part == 0 ? B_u : C_u;
            const float a2 = part == 0 ? AB_a : BC_a;
            const float b2 = part == 0 ? AB_b : BC_b;
            if ((int)lo == (int)hi) continue;
            const int u0 = std::max((int)lo, 0);
            const int u1 = std::min((int)hi, width);
            for (int u = u0; u < u1; ++u) {
                int v1 = (int)(AC_a * (float)u + AC_b);
                int v2 = (int)(a2 * (float)u + b2);
                int vlo = std::max(std::min(v1, v2), 0);
                int vhi = std::min(std::max(v1, v2), height);
                for (int v = vlo; v < vhi; ++v) tri_id[(long)v * width + u] = t;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Triangle-id span code

// Codes the (rows, cols) lattice tri[r * row_stride + c * col_stride] of a
// triangle-id map into out, (rows, s_max, 3) uint8 of [gap, id_lo, id_hi]:
// ids >= t_max read as -1 (coded 0xFFFF); gap is the column delta from the
// previous run's start (0 for a row's first run); a gap over 255 is split
// into 255-gap fillers repeating the previous run's id; runs past s_max are
// dropped; the row's free slots are 255-gap fillers of its last id.
// Returns the longest row's run count (fillers included, dropped runs too),
// or -1 where an id >= 0xFFFF survives the mask (out is then incomplete).
int sv_encode_tri_spans(const int32_t* tri, int rows, int cols,
                        long row_stride, long col_stride, int32_t t_max,
                        int s_max, uint8_t* out) {
    int runs_max = 0;
    std::vector<int> starts(cols);
    for (int r = 0; r < rows; ++r) {
        const int32_t* src = tri + (long)r * row_stride;
        auto at = [&](int c) {
            const int32_t id = src[c * col_stride];
            return id >= t_max ? -1 : id;
        };
        // the row's run starts, with no branch on the pixels: runs are a
        // few pixels long, so a branch at each run's end would mispredict
        int k = 1;
        int32_t prev = at(0);
        starts[0] = 0;
        for (int c = 1; c < cols; ++c) {
            const int32_t id = at(c);
            starts[k] = c;
            k += id != prev;
            prev = id;
        }
        uint8_t* o = out + (long)r * s_max * 3;
        int n = 0;
        auto put = [&](int gap, int32_t id) {
            if (n < s_max) {
                o[3 * n] = (uint8_t)gap;
                o[3 * n + 1] = (uint8_t)(id & 0xFF);
                o[3 * n + 2] = (uint8_t)((id >> 8) & 0xFF);
            }
            ++n;
        };
        int32_t last = -1;
        for (int j = 0; j < k; ++j) {
            const int32_t id = at(starts[j]);
            if (id >= 0xFFFF) return -1;
            int gap = j ? starts[j] - starts[j - 1] : 0;
            for (; gap > 255; gap -= 255) put(255, last);
            put(gap, id);
            last = id;
        }
        runs_max = std::max(runs_max, n);
        while (n < s_max) put(255, last);
    }
    return runs_max;
}

}  // extern "C"
