// Z-buffered software triangle rasterizer with per-vertex normal shading.
//
// Native host-side replacement for the reference's Sim3DR Cython/C++
// rasterizer (simple_romp/vis_human/sim3drender/lib/rasterize_kernel.cpp) —
// an independent implementation: barycentric edge-function rasterization
// with incremental z interpolation, per-vertex Gouraud-shaded colors, and
// alpha compositing over an existing BGR/RGB byte image.
//
// Exposed as a tiny C ABI for ctypes:
//   compute_normals(verts, n_verts, tris, n_tris, out_normals)
//   rasterize(verts, n_verts, tris, n_tris, colors, image, depth, h, w,
//             alpha)
//
// Conventions: verts are (x, y, z) with x right / y down in PIXEL
// coordinates of the target image; larger z is CLOSER to the camera
// (fragments win the depth test when z > depth[y, x]). colors are float
// RGB in [0, 1] per vertex; image is uint8 HxWx3 modified in place; depth
// is float HxW initialized by the caller (e.g. to -1e30).

#include <cmath>
#include <algorithm>
#include <cstring>

extern "C" {

void compute_normals(const float* verts, int n_verts, const int* tris,
                     int n_tris, float* normals) {
    std::memset(normals, 0, sizeof(float) * 3 * n_verts);
    for (int t = 0; t < n_tris; ++t) {
        const int i0 = tris[3 * t], i1 = tris[3 * t + 1], i2 = tris[3 * t + 2];
        const float* a = verts + 3 * i0;
        const float* b = verts + 3 * i1;
        const float* c = verts + 3 * i2;
        const float e1x = b[0] - a[0], e1y = b[1] - a[1], e1z = b[2] - a[2];
        const float e2x = c[0] - a[0], e2y = c[1] - a[1], e2z = c[2] - a[2];
        const float nx = e1y * e2z - e1z * e2y;
        const float ny = e1z * e2x - e1x * e2z;
        const float nz = e1x * e2y - e1y * e2x;
        for (int k : {i0, i1, i2}) {
            normals[3 * k] += nx;
            normals[3 * k + 1] += ny;
            normals[3 * k + 2] += nz;
        }
    }
    for (int v = 0; v < n_verts; ++v) {
        float* n = normals + 3 * v;
        const float len = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
        if (len > 1e-12f) {
            n[0] /= len; n[1] /= len; n[2] /= len;
        }
    }
}

void rasterize(const float* verts, int n_verts, const int* tris, int n_tris,
               const float* colors, unsigned char* image, float* depth,
               int h, int w, float alpha) {
    // Gouraud shading: ambient + headlight diffuse on vertex normals.
    float* normals = new float[3 * n_verts];
    compute_normals(verts, n_verts, tris, n_tris, normals);
    float* shaded = new float[3 * n_verts];
    const float ambient = 0.55f, diffuse = 0.45f;
    for (int v = 0; v < n_verts; ++v) {
        // headlight along +z (towards camera); normals may face either way
        const float lambert = std::fabs(normals[3 * v + 2]);
        const float shade = ambient + diffuse * lambert;
        for (int k = 0; k < 3; ++k) {
            shaded[3 * v + k] = std::min(1.0f, colors[3 * v + k] * shade);
        }
    }

    for (int t = 0; t < n_tris; ++t) {
        const int i0 = tris[3 * t], i1 = tris[3 * t + 1], i2 = tris[3 * t + 2];
        const float* a = verts + 3 * i0;
        const float* b = verts + 3 * i1;
        const float* c = verts + 3 * i2;

        const int x0 = std::max(0, (int)std::floor(
            std::min(a[0], std::min(b[0], c[0]))));
        const int x1 = std::min(w - 1, (int)std::ceil(
            std::max(a[0], std::max(b[0], c[0]))));
        const int y0 = std::max(0, (int)std::floor(
            std::min(a[1], std::min(b[1], c[1]))));
        const int y1 = std::min(h - 1, (int)std::ceil(
            std::max(a[1], std::max(b[1], c[1]))));
        if (x0 > x1 || y0 > y1) continue;

        const float det = (b[0] - a[0]) * (c[1] - a[1])
                        - (c[0] - a[0]) * (b[1] - a[1]);
        if (std::fabs(det) < 1e-12f) continue;
        const float inv_det = 1.0f / det;

        for (int y = y0; y <= y1; ++y) {
            for (int x = x0; x <= x1; ++x) {
                const float px = x + 0.5f, py = y + 0.5f;
                float w1 = ((px - a[0]) * (c[1] - a[1])
                          - (c[0] - a[0]) * (py - a[1])) * inv_det;
                float w2 = ((b[0] - a[0]) * (py - a[1])
                          - (px - a[0]) * (b[1] - a[1])) * inv_det;
                float w0 = 1.0f - w1 - w2;
                if (w0 < 0.f || w1 < 0.f || w2 < 0.f) continue;
                const float z = w0 * a[2] + w1 * b[2] + w2 * c[2];
                float* zb = depth + (size_t)y * w + x;
                if (z <= *zb) continue;
                *zb = z;
                unsigned char* px_out = image + ((size_t)y * w + x) * 3;
                for (int k = 0; k < 3; ++k) {
                    const float col = w0 * shaded[3 * i0 + k]
                                    + w1 * shaded[3 * i1 + k]
                                    + w2 * shaded[3 * i2 + k];
                    const float blended = 255.0f * col * alpha
                        + (1.0f - alpha) * px_out[k];
                    px_out[k] = (unsigned char)std::min(255.0f, blended);
                }
            }
        }
    }
    delete[] normals;
    delete[] shaded;
}

}  // extern "C"
