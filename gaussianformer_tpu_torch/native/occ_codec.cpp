// Native data-path kernels for the host-side loader.
//
// The reference's data pipeline decodes sparse SurroundOcc labels and
// normalizes images in Python/numpy (dataset/transform_3d.py:474-534,
// :142-178). These are the per-sample host hot spots that sit between
// storage and the GPU; doing them in one fused C pass keeps the input
// pipeline off the training step's critical path.
//
// A copy of gaussianformer_tpu/native/occ_codec.cpp, built with g++ and
// bound with ctypes by gaussianformer_tpu_torch/native/__init__.py.

#include <cstdint>
#include <cstring>

extern "C" {

// Sparse [K, 4] (x, y, z, cls) int32 records → dense int32 label grid
// (filled with empty_label) + uint8 camera mask (label != 0), one pass.
void decode_occupancy(const int32_t* records, int64_t num_records,
                      int32_t* label, uint8_t* mask,
                      int64_t X, int64_t Y, int64_t Z,
                      int32_t empty_label) {
    const int64_t total = X * Y * Z;
    for (int64_t i = 0; i < total; ++i) label[i] = empty_label;
    std::memset(mask, 1, total);  // empty_label != 0 → visible
    for (int64_t k = 0; k < num_records; ++k) {
        const int32_t x = records[4 * k + 0];
        const int32_t y = records[4 * k + 1];
        const int32_t z = records[4 * k + 2];
        const int32_t c = records[4 * k + 3];
        if (x < 0 || x >= X || y < 0 || y >= Y || z < 0 || z >= Z) continue;
        const int64_t idx = (x * Y + y) * Z + z;
        label[idx] = c;
        mask[idx] = c != 0;
    }
}

// uint8 HWC image → float32 (x - mean) / std, fused conversion+normalize.
void normalize_image(const uint8_t* src, float* dst,
                     int64_t num_pixels,
                     const float* mean, const float* inv_std) {
    const float m0 = mean[0], m1 = mean[1], m2 = mean[2];
    const float s0 = inv_std[0], s1 = inv_std[1], s2 = inv_std[2];
    for (int64_t i = 0; i < num_pixels; ++i) {
        dst[3 * i + 0] = (static_cast<float>(src[3 * i + 0]) - m0) * s0;
        dst[3 * i + 1] = (static_cast<float>(src[3 * i + 1]) - m1) * s1;
        dst[3 * i + 2] = (static_cast<float>(src[3 * i + 2]) - m2) * s2;
    }
}

// Voxel-center meshgrid [X, Y, Z, 3] (transform_3d.py:487-501).
void occ_meshgrid(float* out, int64_t X, int64_t Y, int64_t Z,
                  float x0, float y0, float z0, float reso) {
    int64_t i = 0;
    for (int64_t x = 0; x < X; ++x) {
        const float fx = x0 + (x + 0.5f) * reso;
        for (int64_t y = 0; y < Y; ++y) {
            const float fy = y0 + (y + 0.5f) * reso;
            for (int64_t z = 0; z < Z; ++z) {
                out[i++] = fx;
                out[i++] = fy;
                out[i++] = z0 + (z + 0.5f) * reso;
            }
        }
    }
}

}  // extern "C"
