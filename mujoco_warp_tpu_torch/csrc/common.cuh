// Shared device helpers of the port's kernels: quaternion and spatial
// algebra on small float arrays, in the conventions of the JAX package
// (quaternions w, x, y, z; motion vectors angular | linear; 10-vector
// inertias Ixx Iyy Izz Ixy Ixz Iyz mcx mcy mcz m).
//
// Every kernel of the port runs one thread per world and has a plain C
// interface for ctypes: launch(const Params*, cudaStream_t) returns a
// cudaError_t, params_size() the size of its Params struct, and
// error_string(int) the message of an error code.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define DEV __device__ __forceinline__

#define PORT_C_INTERFACE(Params, kernel, block)                          \
  extern "C" int params_size() { return (int)sizeof(Params); }           \
  extern "C" const char* error_string(int err) {                         \
    return cudaGetErrorString((cudaError_t)err);                         \
  }                                                                      \
  extern "C" int launch(const Params* p, void* stream) {                 \
    if (p->nworld <= 0) return (int)cudaSuccess;                         \
    int grid = (p->nworld + (block) - 1) / (block);                      \
    kernel<<<grid, (block), 0, (cudaStream_t)stream>>>(*p);              \
    return (int)cudaGetLastError();                                      \
  }

constexpr float kMinVal = 1e-15f;

DEV float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

DEV void cross3(const float* a, const float* b, float* out) {
  float x = a[1] * b[2] - a[2] * b[1];
  float y = a[2] * b[0] - a[0] * b[2];
  float z = a[0] * b[1] - a[1] * b[0];
  out[0] = x; out[1] = y; out[2] = z;
}

// Hamilton product u * v; out may alias u or v
DEV void qmul(const float* u, const float* v, float* out) {
  float w = u[0] * v[0] - u[1] * v[1] - u[2] * v[2] - u[3] * v[3];
  float x = u[0] * v[1] + u[1] * v[0] + u[2] * v[3] - u[3] * v[2];
  float y = u[0] * v[2] - u[1] * v[3] + u[2] * v[0] + u[3] * v[1];
  float z = u[0] * v[3] + u[1] * v[2] - u[2] * v[1] + u[3] * v[0];
  out[0] = w; out[1] = x; out[2] = y; out[3] = z;
}

// rotate vec by quaternion q: v + 2w (qv x v) + 2 qv x (qv x v)
DEV void qrot(const float* vec, const float* q, float* out) {
  float t[3], c[3];
  cross3(q + 1, vec, t);
  t[0] *= 2.0f; t[1] *= 2.0f; t[2] *= 2.0f;
  cross3(q + 1, t, c);
  float r0 = vec[0] + q[0] * t[0] + c[0];
  float r1 = vec[1] + q[0] * t[1] + c[1];
  float r2 = vec[2] + q[0] * t[2] + c[2];
  out[0] = r0; out[1] = r1; out[2] = r2;
}

// q / |q| with |q|^2 floored at 1e-28
DEV void qnormalize(float* q) {
  float inv = rsqrtf(fmaxf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] +
                           q[3] * q[3], 1e-28f));
  q[0] *= inv; q[1] *= inv; q[2] *= inv; q[3] *= inv;
}

// quaternion -> row-major 3x3 rotation matrix
DEV void quat2mat(const float* q, float* m) {
  float w = q[0], x = q[1], y = q[2], z = q[3];
  m[0] = 1 - 2 * (y * y + z * z); m[1] = 2 * (x * y - w * z);
  m[2] = 2 * (x * z + w * y);
  m[3] = 2 * (x * y + w * z); m[4] = 1 - 2 * (x * x + z * z);
  m[5] = 2 * (y * z - w * x);
  m[6] = 2 * (x * z - w * y); m[7] = 2 * (y * z + w * x);
  m[8] = 1 - 2 * (x * x + y * y);
}

// a / |a|, unchanged below a norm of 1e-14 (math.normalize)
DEV void normalize3(float* a) {
  float n = sqrtf(dot3(a, a));
  float d = n < 1e-14f ? 1.0f : n;
  a[0] /= d; a[1] /= d; a[2] /= d;
}

// frame (rows: normal, tangent1, tangent2) from a normal (math.make_frame)
DEV void make_frame(const float* normal, float* f) {
  float a[3] = {normal[0], normal[1], normal[2]};
  normalize3(a);
  float near_vert = fabsf(a[2]) >= 0.5f ? 1.0f : 0.0f;
  float h[3] = {0.0f, near_vert, 1.0f - near_vert};
  float ah = dot3(a, h);
  float b[3] = {h[0] - a[0] * ah, h[1] - a[1] * ah, h[2] - a[2] * ah};
  normalize3(b);
  float c[3];
  cross3(a, b, c);
  for (int i = 0; i < 3; ++i) {
    f[i] = a[i]; f[3 + i] = b[i]; f[6 + i] = c[i];
  }
}

// 10-vector spatial inertia times motion vector -> force vector
DEV void inert_mul(const float* i, const float* v, float* out) {
  const float* ang = v;
  const float* lin = v + 3;
  float mc_lin[3], mc_ang[3];
  cross3(i + 6, lin, mc_lin);
  cross3(i + 6, ang, mc_ang);
  float o0 = i[0] * ang[0] + i[3] * ang[1] + i[4] * ang[2] + mc_lin[0];
  float o1 = i[3] * ang[0] + i[1] * ang[1] + i[5] * ang[2] + mc_lin[1];
  float o2 = i[4] * ang[0] + i[5] * ang[1] + i[2] * ang[2] + mc_lin[2];
  float o3 = i[9] * lin[0] - mc_ang[0];
  float o4 = i[9] * lin[1] - mc_ang[1];
  float o5 = i[9] * lin[2] - mc_ang[2];
  out[0] = o0; out[1] = o1; out[2] = o2; out[3] = o3; out[4] = o4;
  out[5] = o5;
}

// spatial cross product of motion vectors u x v
DEV void motion_cross(const float* u, const float* v, float* out) {
  float a[3], l1[3], l2[3];
  cross3(u, v, a);
  cross3(u, v + 3, l1);
  cross3(u + 3, v, l2);
  out[0] = a[0]; out[1] = a[1]; out[2] = a[2];
  out[3] = l1[0] + l2[0]; out[4] = l1[1] + l2[1]; out[5] = l1[2] + l2[2];
}

// spatial cross product of a motion and a force vector u x* f
DEV void motion_cross_force(const float* u, const float* f, float* out) {
  float a1[3], a2[3], l[3];
  cross3(u, f, a1);
  cross3(u + 3, f + 3, a2);
  cross3(u, f + 3, l);
  out[0] = a1[0] + a2[0]; out[1] = a1[1] + a2[1]; out[2] = a1[2] + a2[2];
  out[3] = l[0]; out[4] = l[1]; out[5] = l[2];
}

// constraint stiffness k, damping b and impedance imp
// (mj_assignRef / mj_getImpedance; constraint.kbi)
DEV void kbi(const float* solref, const float* solimp, float pos_imp,
             float timestep, int refsafe, float* k, float* b, float* imp) {
  const float minimp = 0.0001f, maximp = 0.9999f;
  float timeconst = solref[0], dampratio = solref[1];
  float dmin = fminf(fmaxf(solimp[0], minimp), maximp);
  float dmax = fminf(fmaxf(solimp[1], minimp), maximp);
  float width = fmaxf(solimp[2], kMinVal);
  float mid = fminf(fmaxf(solimp[3], minimp), maximp);
  float power = fmaxf(solimp[4], 1.0f);
  if (refsafe) timeconst = fmaxf(timeconst, 2.0f * timestep);
  float dmax_sq = dmax * dmax;
  float kk = 1.0f / fmaxf(dmax_sq * timeconst * timeconst * dampratio *
                              dampratio, kMinVal);
  float bb = 2.0f / fmaxf(dmax * timeconst, kMinVal);
  if (solref[0] <= 0) kk = -solref[0] / dmax_sq;
  if (solref[1] <= 0) bb = -solref[1] / dmax;
  float x = fabsf(pos_imp) / width;
  float y;
  if (x < mid) {
    y = (1.0f / powf(mid, power - 1.0f)) * powf(x, power);
  } else {
    y = 1.0f - (1.0f / powf(1.0f - mid, power - 1.0f)) *
                   powf(1.0f - x, power);
  }
  float im = fminf(fmaxf(dmin + y * (dmax - dmin), dmin), dmax);
  if (x > 1.0f) im = dmax;
  *k = kk; *b = bb; *imp = im;
}
