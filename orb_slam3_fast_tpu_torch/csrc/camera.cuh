// The pin-hole camera with radial-tangential distortion of
// cameras/models.py, in float32 as the plain versions compute it: the
// distortion of the normalised point (models._distort_radtan) and its
// closed-form 2x2 Jacobian d(xd, yd)/d(x, y) (models.project_jac), so
// d(u, v)/d(xc) = diag(fx, fy) [[a, b], [b, c]] [[1, 0, -x], [0, 1, -y]] / z.
// Kernels D, E, Q and R take it only where the camera has distortion (a
// template flag): a camera without it runs the instructions it ran before.
#pragma once
#include <cuda_runtime.h>

namespace cam {

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

}  // namespace cam
