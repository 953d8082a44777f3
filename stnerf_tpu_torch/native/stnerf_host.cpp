// stnerf_host — native host-side runtime, the PyTorch port's own copy of
// native/stnerf_host.cpp (the same code; the port builds and loads only
// this file).
//
// Replaces the reference's native host dependencies with first-party code:
//   * textured-mesh rasterization (the reference used pyrender + EGL/OpenGL,
//     ref: render/bkgd_renderer.py:24-71) -> a z-buffered, perspective-correct
//     barycentric rasterizer;
//   * PLY point-cloud ingestion (the reference used open3d,
//     ref: data/datasets/frame_dataset.py:45) -> a binary/ascii PLY reader;
//   * full-image ray generation (hot loop of the data pipeline).
//
// Exposed as a C ABI consumed from Python via ctypes (see
// stnerf_tpu_torch/data/native.py, which builds it with g++ into build/native/
// at first use).
//
// Conventions match the Python pipeline: pinhole K (3x3 row-major), c2w
// (4x4 row-major) camera-to-world pose, OpenCV-style camera (x right,
// y down, z forward), pixel (u=col+0, v=row+0) at the ray through K^-1
// [u, v, 1].

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PLY reader: vertex x/y/z to out (cap floats). Returns point count, or -1.
// Supports format ascii / binary_little_endian with scalar vertex properties.
// ---------------------------------------------------------------------------
long stnerf_ply_read_points(const char* path, float* out, long cap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char line[4096];
  if (!std::fgets(line, sizeof line, f) || std::strncmp(line, "ply", 3) != 0) {
    std::fclose(f);
    return -1;
  }
  bool binary = false;
  long count = 0;
  bool in_vertex = false;
  // property byte sizes and x/y/z float-offsets within a vertex record
  std::vector<int> sizes;
  std::vector<char> types;  // 'f' float32, 'd' float64, 'i' other
  int xi = -1, yi = -1, zi = -1;

  auto type_size = [](const std::string& t) -> int {
    if (t == "char" || t == "uchar" || t == "int8" || t == "uint8") return 1;
    if (t == "short" || t == "ushort" || t == "int16" || t == "uint16") return 2;
    if (t == "int" || t == "uint" || t == "int32" || t == "uint32" ||
        t == "float" || t == "float32") return 4;
    return 8;  // double / int64
  };

  while (std::fgets(line, sizeof line, f)) {
    std::string s(line);
    if (s.rfind("format", 0) == 0) {
      binary = s.find("binary_little_endian") != std::string::npos;
      if (s.find("binary_big_endian") != std::string::npos) {
        std::fclose(f);
        return -1;
      }
    } else if (s.rfind("element", 0) == 0) {
      char name[64];
      long n;
      if (std::sscanf(line, "element %63s %ld", name, &n) == 2) {
        in_vertex = std::strcmp(name, "vertex") == 0;
        if (in_vertex) count = n;
      }
    } else if (s.rfind("property", 0) == 0 && in_vertex) {
      char t[32], nm[64];
      if (std::sscanf(line, "property %31s %63s", t, nm) == 2) {
        if (std::strcmp(t, "list") == 0) { std::fclose(f); return -1; }
        std::string ts(t);
        int idx = static_cast<int>(sizes.size());
        sizes.push_back(type_size(ts));
        types.push_back(ts == "float" || ts == "float32" ? 'f'
                        : (ts == "double" || ts == "float64" ? 'd' : 'i'));
        if (std::strcmp(nm, "x") == 0) xi = idx;
        if (std::strcmp(nm, "y") == 0) yi = idx;
        if (std::strcmp(nm, "z") == 0) zi = idx;
      }
    } else if (s.rfind("end_header", 0) == 0) {
      break;
    }
  }
  if (xi < 0 || yi < 0 || zi < 0 || count <= 0 || cap < count * 3) {
    std::fclose(f);
    return -1;
  }

  if (binary) {
    int rec = 0;
    std::vector<int> offs(sizes.size());
    for (size_t i = 0; i < sizes.size(); ++i) { offs[i] = rec; rec += sizes[i]; }
    std::vector<unsigned char> buf(static_cast<size_t>(rec) * count);
    if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) {
      std::fclose(f);
      return -1;
    }
    auto get = [&](long i, int p) -> float {
      const unsigned char* base = buf.data() + static_cast<size_t>(i) * rec + offs[p];
      if (types[p] == 'f') { float v; std::memcpy(&v, base, 4); return v; }
      if (types[p] == 'd') { double v; std::memcpy(&v, base, 8); return (float)v; }
      return 0.0f;
    };
    for (long i = 0; i < count; ++i) {
      out[i * 3 + 0] = get(i, xi);
      out[i * 3 + 1] = get(i, yi);
      out[i * 3 + 2] = get(i, zi);
    }
  } else {
    std::vector<double> vals(sizes.size());
    for (long i = 0; i < count; ++i) {
      for (size_t p = 0; p < sizes.size(); ++p) {
        if (std::fscanf(f, "%lf", &vals[p]) != 1) { std::fclose(f); return -1; }
      }
      out[i * 3 + 0] = (float)vals[xi];
      out[i * 3 + 1] = (float)vals[yi];
      out[i * 3 + 2] = (float)vals[zi];
    }
  }
  std::fclose(f);
  return count;
}

// ---------------------------------------------------------------------------
// Full-image pixel rays: out is (maxh-minh)*(maxw-minw) rows of
// [ox, oy, oz, dx, dy, dz], row-major over the crop.
// ---------------------------------------------------------------------------
void stnerf_pixel_rays(const float* K, const float* c2w, int minh, int maxh,
                       int minw, int maxw, float* out) {
  // K^-1 for an upper-triangular pinhole K
  const float fx = K[0], skew = K[1], cx = K[2];
  const float fy = K[4], cy = K[5];
  const float r00 = c2w[0], r01 = c2w[1], r02 = c2w[2], tx = c2w[3];
  const float r10 = c2w[4], r11 = c2w[5], r12 = c2w[6], ty = c2w[7];
  const float r20 = c2w[8], r21 = c2w[9], r22 = c2w[10], tz = c2w[11];
  long idx = 0;
  for (int v = minh; v < maxh; ++v) {
    for (int u = minw; u < maxw; ++u) {
      float z = 1.0f;
      float y = (v - cy) / fy;
      float x = (u - cx - skew * y) / fx;
      float n = std::sqrt(x * x + y * y + z * z);
      x /= n; y /= n; z /= n;
      float dx = r00 * x + r01 * y + r02 * z;
      float dy = r10 * x + r11 * y + r12 * z;
      float dz = r20 * x + r21 * y + r22 * z;
      out[idx++] = tx; out[idx++] = ty; out[idx++] = tz;
      out[idx++] = dx; out[idx++] = dy; out[idx++] = dz;
    }
  }
}

// ---------------------------------------------------------------------------
// Textured-mesh rasterizer (PrRender replacement).
//   verts (V,3) world-space, uvs (V,2) in [0,1], faces (F,3) vertex ids,
//   texture (th, tw, 3) uint8, K (3,3), w2c (4,4) world-to-camera.
//   rgb out (H,W,3) uint8, depth out (H,W) float32 (camera z; 0 = no hit).
// Perspective-correct barycentric interpolation, z-buffered, no culling.
// ---------------------------------------------------------------------------
void stnerf_rasterize(const float* verts, const float* uvs, long n_verts,
                      const int32_t* faces, long n_faces,
                      const uint8_t* tex, int th, int tw,
                      const float* K, const float* w2c, int H, int W,
                      uint8_t* rgb_out, float* depth_out) {
  (void)n_verts;
  const float fx = K[0], cx = K[2], fy = K[4], cy = K[5];
  std::vector<float> cam(3 * 3);
  std::fill(depth_out, depth_out + (size_t)H * W, 0.0f);
  std::memset(rgb_out, 0, (size_t)H * W * 3);
  std::vector<float> zbuf((size_t)H * W, 1e30f);

  for (long fidx = 0; fidx < n_faces; ++fidx) {
    float px[3], py[3], pz[3], pu[3], pv[3];
    bool ok = true;
    for (int k = 0; k < 3; ++k) {
      int32_t vi = faces[fidx * 3 + k];
      const float* p = verts + (size_t)vi * 3;
      float x = w2c[0] * p[0] + w2c[1] * p[1] + w2c[2] * p[2] + w2c[3];
      float y = w2c[4] * p[0] + w2c[5] * p[1] + w2c[6] * p[2] + w2c[7];
      float z = w2c[8] * p[0] + w2c[9] * p[1] + w2c[10] * p[2] + w2c[11];
      if (z <= 1e-6f) { ok = false; break; }  // behind camera: skip triangle
      px[k] = fx * x / z + cx;
      py[k] = fy * y / z + cy;
      pz[k] = z;
      pu[k] = uvs[(size_t)vi * 2 + 0];
      pv[k] = uvs[(size_t)vi * 2 + 1];
    }
    if (!ok) continue;

    int x0 = std::max(0, (int)std::floor(std::min({px[0], px[1], px[2]})));
    int x1 = std::min(W - 1, (int)std::ceil(std::max({px[0], px[1], px[2]})));
    int y0 = std::max(0, (int)std::floor(std::min({py[0], py[1], py[2]})));
    int y1 = std::min(H - 1, (int)std::ceil(std::max({py[0], py[1], py[2]})));
    if (x0 > x1 || y0 > y1) continue;

    float denom = (py[1] - py[2]) * (px[0] - px[2]) +
                  (px[2] - px[1]) * (py[0] - py[2]);
    if (std::fabs(denom) < 1e-12f) continue;
    float inv_denom = 1.0f / denom;

    for (int y = y0; y <= y1; ++y) {
      for (int x = x0; x <= x1; ++x) {
        float l0 = ((py[1] - py[2]) * (x - px[2]) + (px[2] - px[1]) * (y - py[2])) * inv_denom;
        float l1 = ((py[2] - py[0]) * (x - px[2]) + (px[0] - px[2]) * (y - py[2])) * inv_denom;
        float l2 = 1.0f - l0 - l1;
        if (l0 < 0 || l1 < 0 || l2 < 0) continue;
        // perspective-correct: weight by 1/z
        float w0 = l0 / pz[0], w1 = l1 / pz[1], w2 = l2 / pz[2];
        float wsum = w0 + w1 + w2;
        float z = 1.0f / wsum;
        size_t pix = (size_t)y * W + x;
        if (z >= zbuf[pix]) continue;
        zbuf[pix] = z;
        float u = (w0 * pu[0] + w1 * pu[1] + w2 * pu[2]) * z;
        float v = (w0 * pv[0] + w1 * pv[1] + w2 * pv[2]) * z;
        int tu = std::min(tw - 1, std::max(0, (int)(u * (tw - 1) + 0.5f)));
        int tv = std::min(th - 1, std::max(0, (int)((1.0f - v) * (th - 1) + 0.5f)));
        const uint8_t* texel = tex + ((size_t)tv * tw + tu) * 3;
        rgb_out[pix * 3 + 0] = texel[0];
        rgb_out[pix * 3 + 1] = texel[1];
        rgb_out[pix * 3 + 2] = texel[2];
        depth_out[pix] = z;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Per-camera near/far from a point cloud: z-range of points in each camera's
// frame (ref: data/datasets/frame_dataset.py:209-239).
//   pts (N,3), w2c (M,4,4) row-major -> near (M,), far (M,).
// ---------------------------------------------------------------------------
void stnerf_near_far(const float* pts, long n, const float* w2c, int m,
                     float* near_out, float* far_out) {
  for (int c = 0; c < m; ++c) {
    const float* T = w2c + (size_t)c * 16;
    float lo = 1e30f, hi = -1e30f;
    for (long i = 0; i < n; ++i) {
      const float* p = pts + (size_t)i * 3;
      float z = T[8] * p[0] + T[9] * p[1] + T[10] * p[2] + T[11];
      lo = std::min(lo, z);
      hi = std::max(hi, z);
    }
    near_out[c] = lo;
    far_out[c] = hi;
  }
}

int stnerf_abi_version() { return 1; }

}  // extern "C"
