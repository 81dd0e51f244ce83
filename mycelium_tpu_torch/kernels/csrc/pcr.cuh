// Per-slot bodies of the parallel cyclic reduction (PCR) on 3x3
// block-tridiagonal systems, as device functions shared by K2/K3 (pcr.cu)
// and the whole-solve kernel K6 (tree_cg.cu), so all three compute a level's
// factorization and apply with the same instructions.
//
// Layout: a 3x3 block batch is 9 component planes in row-major component
// order (00, 01, 02, 10, ...), plane c of slot i at m[c * stride + i]; a
// 3-vector batch is 3 planes. The factorization state of one level is 45
// planes of one stride `st`: D at plane 0, L at 9, R at 18 and the 18 corner
// right-hand sides at 27 (plane 27 + 6*q + j is component q of unit column
// j: columns 0:3 sit at every path's first slot, 3:6 at its last). Slots
// outside [0, len) read as zero; that is exact because the couplings are
// zero at every path end.
//
// A level whose paths tile it can be cut into windows of whole paths. PCR
// never couples two paths, so a block that holds a window's state in shared
// memory runs every round on it alone (factor_rounds_window, and
// apply_rounds with the window as its whole extent): slots outside the
// window read as zero exactly as slots outside the level do, and the
// results are the whole level's, up to the sign of a zero.
//
// No pointer carries __restrict__: K6 writes these buffers and reads them
// again after a grid-wide barrier, so its loads must not go through the
// read-only (non-coherent) data path.
//
// Arithmetic order follows the plain PyTorch versions term by term, and the
// library is built with -fmad=false, so the kernels round as the plain
// versions do.

#pragma once

#include <cuda_runtime.h>

namespace pcr {

constexpr int kStatePlanes = 45;

__device__ __forceinline__ void load9(const float* m, long long stride,
                                      long long len, long long i,
                                      float o[9]) {
  if (i >= 0 && i < len) {
    for (int c = 0; c < 9; ++c) o[c] = m[c * stride + i];
  } else {
    for (int c = 0; c < 9; ++c) o[c] = 0.0f;
  }
}

// adjugate inverse, det == 0 -> det = 1 (so inv(0) == 0), as _inv9
__device__ __forceinline__ void inv9(const float m[9], float o[9]) {
  float a = m[0], b = m[1], c = m[2], d = m[3], e = m[4], f = m[5],
        g = m[6], h = m[7], i = m[8];
  float A = e * i - f * h;
  float B = -(d * i - f * g);
  float C = d * h - e * g;
  float det = a * A + b * B + c * C;
  det = (det != 0.0f) ? det : 1.0f;
  o[0] = A / det;
  o[1] = -(b * i - c * h) / det;
  o[2] = (b * f - c * e) / det;
  o[3] = B / det;
  o[4] = (a * i - c * g) / det;
  o[5] = -(a * f - c * d) / det;
  o[6] = C / det;
  o[7] = -(a * h - b * g) / det;
  o[8] = (a * e - b * d) / det;
}

__device__ __forceinline__ void mm9(const float a[9], const float b[9],
                                    float o[9]) {
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k)
      o[3 * i + k] = a[3 * i] * b[k] + a[3 * i + 1] * b[3 + k] +
                     a[3 * i + 2] * b[6 + k];
}

__device__ __forceinline__ void transpose9(const float a[9], float o[9]) {
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) o[3 * i + k] = a[3 * k + i];
}

// One PCR round at distance s for slot i: a = L·inv(D[i-s]),
// b = R·inv(D[i+s]), D -= a·R[i-s] + b·L[i+s], L = -a·L[i-s],
// R = -b·R[i+s], and the corner columns r -= a·r[i-s] + b·r[i+s]. Reads the
// state `cur`, writes `nxt` (both 45 planes of stride st) and this round's
// coefficient planes al, be (9 planes of stride sc each).
__device__ __forceinline__ void round_slot(const float* cur, float* nxt,
                                           float* al, float* be,
                                           long long st, long long sc,
                                           long long len, long long i,
                                           long long s) {
  const float* D = cur;
  const float* L = cur + 9 * st;
  const float* R = cur + 18 * st;
  const float* r = cur + 27 * st;
  float* Dn = nxt;
  float* Ln = nxt + 9 * st;
  float* Rn = nxt + 18 * st;
  float* rn = nxt + 27 * st;
  float t[9], dm[9], dp[9], Li[9], Ri[9], a[9], b[9], x[9], y[9];
  load9(D, st, len, i - s, t);
  inv9(t, dm);
  load9(D, st, len, i + s, t);
  inv9(t, dp);
  load9(L, st, len, i, Li);
  load9(R, st, len, i, Ri);
  mm9(Li, dm, a);
  mm9(Ri, dp, b);

  float Rm[9], Lp[9], Lm[9], Rp[9];
  load9(R, st, len, i - s, Rm);
  load9(L, st, len, i + s, Lp);
  load9(L, st, len, i - s, Lm);
  load9(R, st, len, i + s, Rp);
  mm9(a, Rm, x);
  mm9(b, Lp, y);
  for (int c = 0; c < 9; ++c) Dn[c * st + i] = D[c * st + i] - (x[c] + y[c]);
  mm9(a, Lm, x);
  for (int c = 0; c < 9; ++c) Ln[c * st + i] = -x[c];
  mm9(b, Rp, y);
  for (int c = 0; c < 9; ++c) Rn[c * st + i] = -y[c];
  for (int c = 0; c < 9; ++c) {
    al[c * sc + i] = a[c];
    be[c * sc + i] = b[c];
  }

  bool hm = i - s >= 0, hp = i + s < len;
  for (int j = 0; j < 6; ++j) {
    float rm[3], rp[3];
    for (int q = 0; q < 3; ++q) {
      rm[q] = hm ? r[(6 * q + j) * st + i - s] : 0.0f;
      rp[q] = hp ? r[(6 * q + j) * st + i + s] : 0.0f;
    }
    for (int q = 0; q < 3; ++q) {
      float am = a[3 * q] * rm[0] + a[3 * q + 1] * rm[1] +
                 a[3 * q + 2] * rm[2];
      float bp = b[3 * q] * rp[0] + b[3 * q + 1] * rp[1] +
                 b[3 * q + 2] * rp[2];
      rn[(6 * q + j) * st + i] = r[(6 * q + j) * st + i] - (am + bp);
    }
  }
}

// Every round of one window of wl whole-path slots whose state sits in
// shared memory (cur, nxt: 45 planes of stride st each), with
// __syncthreads() between the rounds. al, be point at the window's first
// slot in the level's coefficient planes (plane stride sc, 9 planes a
// round). Every thread of the block calls it; the state must be complete
// (a __syncthreads() after it was written). Returns the buffer that holds
// the final state.
__device__ __forceinline__ float* factor_rounds_window(float* cur, float* nxt,
                                                       int st, int wl,
                                                       int steps, float* al,
                                                       float* be,
                                                       long long sc) {
  long long s = 1;
  for (int k = 0; k < steps; ++k) {
    float* alk = al + (long long)k * 9 * sc;
    float* bek = be + (long long)k * 9 * sc;
    for (int i = threadIdx.x; i < wl; i += blockDim.x)
      round_slot(cur, nxt, alk, bek, st, sc, wl, i, s);
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
    s *= 2;
  }
  return cur;
}

// After the last round: d = inv(D[i]) and the corner solution
// xc[6*q + j] = (d · r[:, j])[q] of slot i.
__device__ __forceinline__ void final_slot(const float* cur, long long st,
                                           long long len, long long i,
                                           float d[9], float xc[18]) {
  float t[9];
  load9(cur, st, len, i, t);
  inv9(t, d);
  const float* r = cur + 27 * st;
  for (int j = 0; j < 6; ++j) {
    float v[3];
    for (int q = 0; q < 3; ++q) v[q] = r[(6 * q + j) * st + i];
    for (int q = 0; q < 3; ++q)
      xc[6 * q + j] = d[3 * q] * v[0] + d[3 * q + 1] * v[1] +
                      d[3 * q + 2] * v[2];
  }
}

// One round of the apply for window position w (slot pos of the level):
// nxt = cur - (a·cur[w-s] + b·cur[w+s]) on a 3 x W window in shared memory;
// ak, bk are the round's coefficient planes (stride sc).
__device__ __forceinline__ void apply_round_slot(const float* cur, float* nxt,
                                                 int W, int w, int s,
                                                 const float* ak,
                                                 const float* bk,
                                                 long long sc,
                                                 long long pos) {
  float rm[3], rp[3];
  for (int c = 0; c < 3; ++c) {
    rm[c] = (w - s >= 0) ? cur[c * W + w - s] : 0.0f;
    rp[c] = (w + s < W) ? cur[c * W + w + s] : 0.0f;
  }
  for (int q = 0; q < 3; ++q) {
    float am = ak[(3 * q) * sc + pos] * rm[0] +
               ak[(3 * q + 1) * sc + pos] * rm[1] +
               ak[(3 * q + 2) * sc + pos] * rm[2];
    float bp = bk[(3 * q) * sc + pos] * rp[0] +
               bk[(3 * q + 1) * sc + pos] * rp[1] +
               bk[(3 * q + 2) * sc + pos] * rp[2];
    nxt[q * W + w] = cur[q * W + w] - (am + bp);
  }
}

// The rounds of one level's apply on a window of W = chunk + 2·halo slots
// starting at slot `base` (may be negative) of a level of len slots: the
// window's right-hand side is in `cur`; returns the buffer that holds the
// reduced right-hand side (cur or nxt). Every thread of the block calls it.
__device__ __forceinline__ float* apply_rounds(float* cur, float* nxt, int W,
                                               long long base, long long len,
                                               int steps, const float* al,
                                               const float* be,
                                               long long sc) {
  int s = 1;
  for (int k = 0; k < steps; ++k) {
    const float* ak = al + (long long)k * 9 * sc;
    const float* bk = be + (long long)k * 9 * sc;
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      long long pos = base + w;
      if (pos < 0 || pos >= len) {
        for (int c = 0; c < 3; ++c) nxt[c * W + w] = 0.0f;
        continue;
      }
      apply_round_slot(cur, nxt, W, w, s, ak, bk, sc, pos);
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
    s *= 2;
  }
  return cur;
}

}  // namespace pcr
