// Forward shading and surface encode of LIT and LIT_SHADOW in one pass.
//
// Replaces no TPU kernel: the JAX package shades with plain tensor code
// (kanirenderer_tpu/shade/forward.py `shade_lit`, the clear-colour compose
// and the surface encode of kanirenderer_tpu/passes/frame.py
// `render_band`), and so does the port's plain path, which this kernel
// computes in one launch per band: passes/frame.band_shade
// (shade/forward.shade_lit, then the clear colour where no triangle
// covers) followed by passes/frame.band_surface (sRGB encode and the u8
// store, or the clamp and the float16 store with hdr).  Per pixel: the
// bilinear diffuse and normal-map samples from the combined block table
// (ops/sampling.sample_materials_combined), the 3x3 PCF of the shadow
// table (ops/sampling.sample_shadow_pcf, LIT_SHADOW only), Blinn-Phong
// for the movable light, the directional light and the point-light array,
// Reinhard or ACES, the clear colour, the encode and the store.
//
// What bounds it on this card: bytes and the gathers.  The plain path is
// some 360 launches of full-frame passes whose per-lane intermediates
// (121 f32 lanes a pixel for the PCF, 120 for the texture row, each
// written out in full) move gigabytes a frame.  This kernel reads each
// pixel's 17 varying planes, 4 material planes and the mask once (85
// bytes, coalesced along the row) and writes 3 bytes (6 with hdr); the
// bilinear hat weights are non-zero on 2 lanes per axis and the PCF's
// trapezoid weights on 4, so it gathers the 2x2 texels of the texture row
// (24 bytes) and the 4x4 taps of the shadow row (64 bytes) only.
// Neighbouring pixels share texture and shadow rows, which the read-only
// cache and L2 serve; the shadow table of a 2048^2 map (33.5 MB) fits in
// L2.  One thread per pixel, 32 x 8 blocks, so a warp reads a row segment
// of every plane.
//
// Arithmetic: float32, the plain path's operations in its order, without
// fused multiply-adds (-fmad=false), with the CUDA math functions
// PyTorch's kernels call (rsqrtf, sqrtf, floorf, powf; IEEE division), and
// the same NaN-propagating clamps.  Where PyTorch divides by a Python
// scalar on the card it multiplies by the float reciprocal (the PCF's
// / 9), and so does this kernel.  What differs is the order of the two
// lane reductions: the texture's sum over its 20 window lanes becomes the
// sum of its 4 non-zero terms, taken as PyTorch's reduction takes them
// (a running sum per window column, then the columns in order), and the
// PCF's sum over 121 lanes becomes the sum of its 16 non-zero taps, row
// by row, which rounds differently from PyTorch's warp tree in the last
// place.  Terms with a zero weight add exactly nothing, so the sums
// differ only in order.
//
// The sun's direction is normalised on the device before the launch
// (torch.linalg.vector_norm, as the plain path does); camera, lights and
// the light's view-projection are read on the device, so the launch needs
// no host read.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32, kBlockY = 8;
constexpr int kUsed = 17;  // varying planes (ops/vertex.py USED)
// The combined table (ops/sampling.py CMB_*): 3x4-texel blocks whose 4x5
// windows x 6 channels fill a 128-byte row.
constexpr int kCmbBx = 3, kCmbBy = 4, kCmbWinX = 4, kRow = 128;
// The shadow table: 8x8-texel blocks, 11x11 windows in a 128-float row.
constexpr int kShB = 8, kShWin = 11;

struct ShadeArgs {
  const float* vary;                 // (17, rows, W)
  const int* tex_w;                  // (rows, W) each
  const int* tex_h;
  const int* blk_base;
  const int* blk_w;
  const unsigned char* mask;         // (rows, W) bool
  const unsigned char* tex;          // (R, 128) u8 combined table
  const float* table;                // ((D/8)^2, 128) f32, or null (LIT)
  int shadow_dim;
  const float* light_vp;             // (4, 4)
  const float* cam_pos;              // (3,)
  const float* mov_pos;              // (3,)
  const float* mov_color;            // (3,)
  const float* mov_range;            // ()
  const float* sun_dir;              // (3,) the light's direction
  const float* sun_norm;             // () its norm
  const float* sun_color;            // (3,)
  const float* pt_pos;               // (P, 3)
  const float* pt_color;             // (P, 3)
  const float* pt_range;             // (P,)
  int num_points;
  float clear[3];
  int rows, width;
  void* out;                         // (rows, W, 3) u8, or f16 with hdr
};

// torch.clamp and friends on the card: NaN passes through.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// shade/forward._norm3: v * rsqrt(clamp(v.v, min=1e-30)).
__device__ __forceinline__ void norm3(float* v) {
  const float r = rsqrtf(clamp_min(dot3(v, v), 1e-30f));
  v[0] = v[0] * r;
  v[1] = v[1] * r;
  v[2] = v[2] * r;
}

// shade/forward.tbn_apply(vary, p) - tan_pos, normalised: the tangent-space
// direction from the pixel to the world point p.
__device__ __forceinline__ void tangent_dir(const float* t, const float* b,
                                            const float* n,
                                            const float* tan_pos,
                                            const float* p, float* out) {
  out[0] = (t[0] * p[0] + t[1] * p[1] + t[2] * p[2]) - tan_pos[0];
  out[1] = (b[0] * p[0] + b[1] * p[1] + b[2] * p[2]) - tan_pos[1];
  out[2] = (n[0] * p[0] + n[1] * p[1] + n[2] * p[2]) - tan_pos[2];
  norm3(out);
}

// shade/forward._blinn_phong without the light's colour: (diff, spec).
__device__ __forceinline__ void blinn_phong(const float* normal,
                                            const float* light_dir,
                                            const float* view_dir,
                                            float* diff, float* spec) {
  float half_dir[3] = {view_dir[0] + light_dir[0], view_dir[1] + light_dir[1],
                       view_dir[2] + light_dir[2]};
  norm3(half_dir);
  *diff = clamp_min(dot3(normal, light_dir), 0.0f);
  const float s1 = clamp_min(dot3(normal, half_dir), 0.0f);
  const float s2 = s1 * s1;
  const float s4 = s2 * s2;
  const float s8 = s4 * s4;
  const float s16 = s8 * s8;
  *spec = s16 * s16;  // x^32 by five squarings
}

// shade/forward._attenuation.
__device__ __forceinline__ float attenuation(float dist, float rng) {
  const float den = (1.0f + 0.09f * dist) + (0.032f * dist) * dist;
  const float att = 1.0f / den;
  const float q = dist / clamp_min(rng, 1e-20f);
  const float q2 = q * q;
  return att * clamp01(1.0f - q2 * q2);
}

// sqrt(clamp(|p - w|^2, min=1e-30)).
__device__ __forceinline__ float light_distance(const float* p,
                                                const float* w) {
  const float d[3] = {p[0] - w[0], p[1] - w[1], p[2] - w[2]};
  return sqrtf(clamp_min(dot3(d, d), 1e-30f));
}

// Python's int remainder and floor division, as torch's integer kernels.
__device__ __forceinline__ int int_remainder(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}

// ops/sampling._hat: max(0, 1 - |lane - a|).
__device__ __forceinline__ float hat(int lane, float a) {
  return clamp_min(1.0f - fabsf((float)lane - a), 0.0f);
}

// ops/sampling._trapezoid.
__device__ __forceinline__ float trapezoid(int lane, float a) {
  const float d = (float)lane - a;
  return clamp01(minimum(d + 1.0f, 3.0f - d));
}

// ops/sampling.sample_materials_combined at one pixel: diffuse (linear)
// and the raw normal-map sample.  Of the window's 5 x 4 hat weights only
// rows ly, ly + 1 and columns lx, lx + 1 can be non-zero (a = l + f with f
// in [0, 1)).  PyTorch sums the 20 lanes of a channel with four running
// sums, lane k into sum k mod 4, which is the window column; each column's
// sum takes its rows in order, then the columns are added in order.
__device__ __forceinline__ void sample_material(const ShadeArgs& a, int p,
                                                float u, float v,
                                                float* diffuse,
                                                float* normal) {
  const int tw = a.tex_w[p], th = a.tex_h[p];
  const float tx = u * (float)tw - 0.5f;
  const float ty = v * (float)th - 0.5f;
  const float x0 = floorf(tx), y0 = floorf(ty);
  const float fx = tx - x0, fy = ty - y0;
  const int x0i = int_remainder((int)x0, tw);
  const int y0i = int_remainder((int)y0, th);
  const int bx = floor_div(x0i, kCmbBx), by = floor_div(y0i, kCmbBy);
  const int lx = x0i - bx * kCmbBx, ly = y0i - by * kCmbBy;
  const int row = a.blk_base[p] + by * a.blk_w[p] + bx;
  const float ax = (float)lx + fx, ay = (float)ly + fy;
  const float wy[2] = {hat(ly, ay), hat(ly + 1, ay)};
  const float wx[2] = {hat(lx, ax), hat(lx + 1, ax)};
  const unsigned char* win = a.tex + (size_t)row * kRow;
  const float kDiffuse = (float)(1.0 / 65025.0);
  const float kNormal = (float)(1.0 / 255.0);
  float col[2][6];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const unsigned char* texel = win + ((ly + r) * kCmbWinX + lx + c) * 6;
      const float w = wy[r] * wx[c];
#pragma unroll
      for (int ch = 0; ch < 6; ++ch) {
        const float t = (float)__ldg(texel + ch);
        const float term = ch < 3 ? ((t * kDiffuse) * t) * w
                                  : (kNormal * t) * w;
        col[c][ch] = r == 0 ? term : col[c][ch] + term;
      }
    }
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    diffuse[ch] = col[0][ch] + col[1][ch];
    normal[ch] = col[0][ch + 3] + col[1][ch + 3];
  }
}

// shade/forward.shadow_coords + ops/sampling.sample_shadow_pcf at one
// pixel: the 4 x 4 taps of the 11 x 11 window that the trapezoid weights
// leave non-zero, the depth test against the 16-bit table, / 9 as the card
// divides by a scalar.
__device__ __forceinline__ float shadow_pcf(const ShadeArgs& a,
                                            const float* w) {
  const float* L = a.light_vp;
  const float l00 = __ldg(L + 0), l01 = __ldg(L + 1), l02 = __ldg(L + 2),
              l03 = __ldg(L + 3), l10 = __ldg(L + 4), l11 = __ldg(L + 5),
              l12 = __ldg(L + 6), l13 = __ldg(L + 7), l20 = __ldg(L + 8),
              l21 = __ldg(L + 9), l22 = __ldg(L + 10), l23 = __ldg(L + 11);
  const float su = (((l00 * w[0] + l01 * w[1]) + l02 * w[2]) + l03) * 0.5f
                   + 0.5f;
  const float sv = (((l10 * w[0] + l11 * w[1]) + l12 * w[2]) + l13) * -0.5f
                   + 0.5f;
  const float sz = ((l20 * w[0] + l21 * w[1]) + l22 * w[2]) + l23;
  const int D = a.shadow_dim, nb = D / kShB;
  const float tx = su * (float)D - 0.5f;
  const float ty = sv * (float)D - 0.5f;
  const float x0 = floorf(tx), y0 = floorf(ty);
  const float fx = tx - x0, fy = ty - y0;
  const int x0i = min(max((int)x0, 0), D - 1);
  const int y0i = min(max((int)y0, 0), D - 1);
  const int blk = (y0i >> 3) * nb + (x0i >> 3);
  const int ly = y0i & (kShB - 1), lx = x0i & (kShB - 1);
  const float ax = (float)lx + fx, ay = (float)ly + fy;
  const float ref = sz * 65535.0f;
  const float* win = a.table + (size_t)blk * kRow + ly * kShWin + lx;
  float wx[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) wx[c] = trapezoid(lx + c, ax);
  float sum = 0.0f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float wy = trapezoid(ly + r, ay);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (ref <= __ldg(win + r * kShWin + c)) sum = sum + wy * wx[c];
    }
  }
  return sum * (1.0f / 9.0f);
}

// core/color.linear_to_srgb.
__device__ __forceinline__ float linear_to_srgb(float c) {
  c = clamp01(c);
  return c <= 0.0031308f
             ? c * 12.92f
             : 1.055f * powf(c, (float)(1.0 / 2.4)) - 0.055f;
}

template <bool kHdr>
__device__ __forceinline__ void store(const ShadeArgs& a, int p,
                                      const float* rgb) {
  if (kHdr) {
    __half* out = static_cast<__half*>(a.out) + (size_t)p * 3;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      out[ch] = __float2half_rn(clamp01(rgb[ch]));
  } else {
    unsigned char* out = static_cast<unsigned char*>(a.out) + (size_t)p * 3;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float q = linear_to_srgb(rgb[ch]) * 255.0f + 0.5f;
      out[ch] = (unsigned char)(int)fminf(fmaxf(q, 0.0f), 255.0f);
    }
  }
}

template <bool kShadow, bool kHdr>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    shade_forward_kernel(const ShadeArgs a) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= a.width || y >= a.rows) return;
  const int p = y * a.width + x;
  if (!a.mask[p]) {
    store<kHdr>(a, p, a.clear);
    return;
  }
  const size_t plane = (size_t)a.rows * a.width;
  float vary[kUsed];
#pragma unroll
  for (int k = 0; k < kUsed; ++k) vary[k] = a.vary[k * plane + p];
  const float* tan_pos = vary;
  const float* t = vary + 3;
  const float* b = vary + 6;
  const float* n = vary + 9;
  const float* world = vary + 12;

  float color[3], sample[3];
  sample_material(a, p, vary[15], vary[16], color, sample);
  float normal_raw[3], normal[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    normal_raw[ch] = sample[ch] * 2.0f - 1.0f;
    normal[ch] = normal_raw[ch];
  }
  norm3(normal);

  float cam[3], view_dir[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) cam[ch] = __ldg(a.cam_pos + ch);
  tangent_dir(t, b, n, tan_pos, cam, view_dir);

  // the movable point light
  float pos[3], dir[3], diff, spec;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) pos[ch] = __ldg(a.mov_pos + ch);
  const float m_att = attenuation(light_distance(pos, world),
                                  __ldg(a.mov_range));
  tangent_dir(t, b, n, tan_pos, pos, dir);
  blinn_phong(normal, dir, view_dir, &diff, &spec);
  float movable[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float lc = __ldg(a.mov_color + ch);
    movable[ch] = ((lc * diff + lc * spec) * m_att) * color[ch];
  }

  // the directional light, in shadow with LIT_SHADOW
  const float sun_norm = __ldg(a.sun_norm);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) dir[ch] = -__ldg(a.sun_dir + ch) / sun_norm;
  blinn_phong(normal, dir, view_dir, &diff, &spec);
  float shadow = 1.0f;
  if (kShadow) shadow = shadow_pcf(a, world);
  float sun[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float lc = __ldg(a.sun_color + ch);
    float term = (lc * diff) * 10.0f + (lc * spec) * 5.0f;
    if (kShadow) term = term * shadow;
    sun[ch] = term * color[ch];
  }

  // the point-light array in light order, with the raw tangent normal
  float points[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < a.num_points; ++k) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) pos[ch] = __ldg(a.pt_pos + 3 * k + ch);
    const float att = attenuation(light_distance(pos, world),
                                  __ldg(a.pt_range + k));
    tangent_dir(t, b, n, tan_pos, pos, dir);
    blinn_phong(normal_raw, dir, view_dir, &diff, &spec);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float lc = __ldg(a.pt_color + 3 * k + ch);
      points[ch] = points[ch] + (lc * diff + lc * spec) * att;
    }
  }

  float rgb[3];
  const float kAmbient = (float)(20.0 * 0.0005);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float c = ((kAmbient * color[ch] + sun[ch]) + movable[ch])
                    + points[ch] * color[ch];
    if (kHdr) {  // core/color.aces_tonemap
      rgb[ch] = clamp01((c * (2.51f * c + 0.03f))
                        / (c * (2.43f * c + 0.59f) + 0.14f));
    } else {     // core/color.reinhard_tonemap
      rgb[ch] = c / (c + 1.0f);
    }
  }
  store<kHdr>(a, p, rgb);
}

}  // namespace

extern "C" int kani_shade_forward(
    const float* vary, const int* tex_w, const int* tex_h,
    const int* blk_base, const int* blk_w, const unsigned char* mask,
    const unsigned char* tex, const float* table, int shadow_dim,
    const float* light_vp, const float* cam_pos, const float* mov_pos,
    const float* mov_color, const float* mov_range, const float* sun_dir,
    const float* sun_norm, const float* sun_color, const float* pt_pos,
    const float* pt_color, const float* pt_range, int num_points,
    float clear_r, float clear_g, float clear_b, int hdr, int rows,
    int width, void* out, void* stream) {
  if (rows > 0 && width > 0) {
    const ShadeArgs a{vary, tex_w, tex_h, blk_base, blk_w, mask, tex, table,
                      shadow_dim, light_vp, cam_pos, mov_pos, mov_color,
                      mov_range, sun_dir, sun_norm, sun_color, pt_pos,
                      pt_color, pt_range, num_points,
                      {clear_r, clear_g, clear_b}, rows, width, out};
    const dim3 block(kBlockX, kBlockY);
    const dim3 grid((width + kBlockX - 1) / kBlockX,
                    (rows + kBlockY - 1) / kBlockY);
    auto kernel = table ? (hdr ? shade_forward_kernel<true, true>
                               : shade_forward_kernel<true, false>)
                        : (hdr ? shade_forward_kernel<false, true>
                               : shade_forward_kernel<false, false>);
    kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
