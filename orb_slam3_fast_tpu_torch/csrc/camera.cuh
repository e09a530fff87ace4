// The cameras of cameras/models.py, in float32 as the plain versions compute
// them:
//  * the pin-hole camera with radial-tangential distortion: the distortion of
//    the normalised point (models._distort_radtan) and its closed-form 2x2
//    Jacobian d(xd, yd)/d(x, y) (models.project_jac), so
//    d(u, v)/d(xc) = diag(fx, fy) [[a, b], [b, c]] [[1, 0, -x], [0, 1, -y]] / z;
//  * the Kannala-Brandt camera (KB8): the projection of models.project with
//    r = sqrt(x^2 + y^2 + EPS^2), theta = atan2(r, z) and the degree-9 odd
//    polynomial, the closed form of its 2x3 Jacobian (the plain version takes
//    torch.func.jacfwd of that same expression, EPS included), and the
//    10-step Newton unprojection of models.unproject.
// A kernel takes the camera's kind as a template parameter (Kind): a camera
// without distortion runs the instructions it ran before there were kinds,
// and so does a radial-tangential one.  The kernels' (10,) camera slots are
// fx fy cx cy bf k1 k2 p1 p2 k3 (pin-hole) or fx fy cx cy bf k1 k2 k3 k4 0
// (KB8; optim/pose_opt.kernel_camera).
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace cam {

enum Kind : int { kPinhole = 0, kRadtan = 1, kKB8 = 2 };

struct Radtan {
  float k1, k2, p1, p2, k3;
};

__device__ __forceinline__ void distort(const Radtan& d, float x, float y, float& xd, float& yd) {
  const float r2 = x * x + y * y;
  const float radial = 1.0f + r2 * (d.k1 + r2 * (d.k2 + r2 * d.k3));
  xd = x * radial + 2.0f * d.p1 * x * y + d.p2 * (r2 + 2.0f * x * x);
  yd = y * radial + d.p1 * (r2 + 2.0f * y * y) + 2.0f * d.p2 * x * y;
}

// Rows of d(u, v)/d(xc) at the normalised point (x, y) with iz = 1 / z.
__device__ __forceinline__ void pixel_jac(float fx, float fy, const Radtan& d, float x, float y, float iz,
                                          float (&J)[2][3]) {
  const float r2 = x * x + y * y;
  const float radial = 1.0f + r2 * (d.k1 + r2 * (d.k2 + r2 * d.k3));
  const float dradial = d.k1 + r2 * (2.0f * d.k2 + 3.0f * d.k3 * r2);  // d radial / d r2
  const float a = radial + 2.0f * x * x * dradial + 2.0f * d.p1 * y + 6.0f * d.p2 * x;
  const float b = 2.0f * x * y * dradial + 2.0f * d.p1 * x + 2.0f * d.p2 * y;  // dxd/dy == dyd/dx
  const float c = radial + 2.0f * y * y * dradial + 6.0f * d.p1 * y + 2.0f * d.p2 * x;
  J[0][0] = fx * a * iz, J[0][1] = fx * b * iz, J[0][2] = -fx * (a * x + b * y) * iz;
  J[1][0] = fy * b * iz, J[1][1] = fy * c * iz, J[1][2] = -fy * (b * x + c * y) * iz;
}

// A host array of coefficients (k1 k2 p1 p2 k3) as a Radtan.
inline Radtan from(const float* k) { return {k[0], k[1], k[2], k[3], k[4]}; }

inline bool any(const Radtan& d) { return d.k1 != 0.f || d.k2 != 0.f || d.p1 != 0.f || d.p2 != 0.f || d.k3 != 0.f; }

// --- Kannala-Brandt (KB8) ---------------------------------------------------

struct KB8 {
  float fx, fy, cx, cy, k1, k2, k3, k4;
};

constexpr float kEps = 1e-9f;          // models._EPS
constexpr float kEps2 = 1e-18f;        // _EPS * _EPS, as float32
constexpr float kPi = 3.14159265f;     // torch.pi as float32

// theta (1 + t2 (k1 + t2 (k2 + t2 (k3 + t2 k4)))) and its derivative in theta.
__device__ __forceinline__ float kb8_poly(const KB8& c, float theta) {
  const float t2 = theta * theta;
  return theta * (1.0f + t2 * (c.k1 + t2 * (c.k2 + t2 * (c.k3 + t2 * c.k4))));
}

__device__ __forceinline__ float kb8_dpoly(const KB8& c, float theta) {
  const float t2 = theta * theta;
  return 1.0f + t2 * (3.0f * c.k1 + t2 * (5.0f * c.k2 + t2 * (7.0f * c.k3 + t2 * 9.0f * c.k4)));
}

// models.project, KB8: the pixel of camera point (x, y, z).
__device__ __forceinline__ void kb8_project(const KB8& c, float x, float y, float z, float& u, float& v) {
  const float r = sqrtf(x * x + y * y + kEps2);
  const float scale = kb8_poly(c, atan2f(r, z)) / r;
  u = c.fx * scale * x + c.cx;
  v = c.fy * scale * y + c.cy;
}

// d(u, v)/d(x, y, z) of kb8_project: with s = d(theta) / r,
// ds/dr = (d'(theta) z / (r^2 + z^2) - s) / r and ds/dz = -d'(theta) / (r^2 + z^2),
// u = fx s x + cx: du/dx = fx (s + x ds/dr x / r), du/dy = fx x ds/dr y / r, du/dz = fx x ds/dz.
__device__ __forceinline__ void kb8_jac(const KB8& c, float x, float y, float z, float (&J)[2][3]) {
  const float r2 = x * x + y * y + kEps2;
  const float r = sqrtf(r2);
  const float theta = atan2f(r, z);
  const float s = kb8_poly(c, theta) / r;
  const float dd = kb8_dpoly(c, theta);
  const float den = r2 + z * z;
  const float ds_dr_r = (dd * z / den - s) / r / r;  // (ds/dr) / r
  const float ds_dz = -dd / den;
  J[0][0] = c.fx * (s + x * x * ds_dr_r), J[0][1] = c.fx * x * y * ds_dr_r, J[0][2] = c.fx * x * ds_dz;
  J[1][0] = c.fy * x * y * ds_dr_r, J[1][1] = c.fy * (s + y * y * ds_dr_r), J[1][2] = c.fy * y * ds_dz;
}

// models.unproject, KB8: the unit-z ray (x, y, 1) of pixel (u, v) by 10 Newton steps on the polynomial.
__device__ __forceinline__ void kb8_unproject(const KB8& c, float u, float v, float& x, float& y) {
  const float mx = (u - c.cx) / c.fx, my = (v - c.cy) / c.fy;
  const float d = fminf(fmaxf(sqrtf(mx * mx + my * my), 0.0f), kPi);
  float theta = d;
  for (int it = 0; it < 10; ++it) {
    const float dp = kb8_dpoly(c, theta);
    theta = theta - (kb8_poly(c, theta) - d) / (fabsf(dp) < kEps ? kEps : dp);
  }
  const float scale = d < kEps ? 1.0f : tanf(theta) / fmaxf(d, kEps);
  x = mx * scale;
  y = my * scale;
}

// The (10,) kernel slots fx fy cx cy bf k1 k2 k3 k4 of a KB8 camera.
__host__ __device__ inline KB8 kb8_from10(const float* c) { return {c[0], c[1], c[2], c[3], c[5], c[6], c[7], c[8]}; }

// models.stereo_project(_jac), KB8: (u, v) and the rows of d(u, v, u_r)/d(xc) at camera point xc, with
// iz = 1 / z of the safe z (u_r = u - bf iz).
__device__ __forceinline__ void kb8_rows(const KB8& c, float bf, const float (&xc)[3], float iz, float& u, float& v,
                                         float (&A)[3][3]) {
  kb8_project(c, xc[0], xc[1], xc[2], u, v);
  float J[2][3];
  kb8_jac(c, xc[0], xc[1], xc[2], J);
  for (int k = 0; k < 3; ++k) A[0][k] = A[2][k] = J[0][k], A[1][k] = J[1][k];
  A[2][2] = J[0][2] + bf * iz * iz;
}

}  // namespace cam
