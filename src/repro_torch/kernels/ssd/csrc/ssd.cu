// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd/kernel.py (ssd_pallas /
// _ssd_kernel).  It computes the same function, per batch row b and head h
// (group g = h / (H / G)), over chunks of L rows with cum the inclusive
// within-chunk cumsum of a_h * dt and total = cum[L - 1]:
//   y_intra = ((C B^T) * exp(cum_i - cum_j) * dt_j * [i >= j]) @ X
//   y_inter = exp(cum_i) * (C @ state)
//   y       = y_intra + y_inter + d_h * X              (written in x's type)
//   state   = exp(total) * state + (B * exp(total - cum) * dt)^T @ X
// starting from init_state (or zeros) and writing the final fp32 state.
//
// Design (the simple first version):
//  * One block per (b, h).  The loop over chunks inside the block replaces
//    the Pallas kernel's sequential chunk grid axis; the fp32 N x P state
//    stays in shared memory across the whole walk.
//  * Per chunk, B, C and X are staged in shared memory as fp32 (rows are
//    padded by 4 floats so that neighbouring lanes hit different banks).
//    The decay-weighted C B^T matrix is never held whole: it is built in
//    strips of 32 rows, and each strip is consumed by its rows of y at
//    once, so the L x L weights never exist (fp32 B, C, X, state and one
//    strip come to 218 KB at L 128, N 128, P 64).
//  * Ragged S is handled here: rows past S act as dt = 0 and x = 0, which
//    is exact (decay 1, no injection), and their y is not written.  x, B
//    and C may be strided views (the model passes slices of the conv
//    output); only their last dimension must be contiguous.
//  * The products run as fp32 FMAs on the CUDA cores from shared memory,
//    with 4x4, 2x4 and 8x4 register tiles.
//
// What bounds it on this card: at the serving shapes of mamba2-2.7b
// (H 80, P 64, N 128, G 1, L 128) the function is memory-bound: S 2048 at
// batch 1 moves ~46 MB (x in, y out, B, C, dt, state) for ~8 GFLOP, so
// ~14 us at 3.35 TB/s.  This version is far from that by design: it runs
// only B * H = 80 blocks on 132 SMs at batch 1, does its arithmetic on fp32
// CUDA cores rather than tensor cores, and recomputes C B^T once per head
// although with G = 1 all 80 heads share it.  A later redesign would
// split the sequence or the head dim across more blocks, share C B^T
// across the heads of a group, and use wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int STRIP = 32;  // rows of the weight matrix held at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& v) {
  acc.x += s * v.x;
  acc.y += s * v.y;
  acc.z += s * v.z;
  acc.w += s * v.w;
}

struct Args {
  const void* x;      // (B, S, H, P), element strides x_sb, x_ss, x_sh
  const float* dt;    // (B, S, H), strides dt_sb, dt_ss, dt_sh
  const float* a;     // (H,)
  const void* b;      // (B, S, G, N), strides b_sb, b_ss, b_sg
  const void* c;      // (B, S, G, N), strides c_sb, c_ss, c_sg
  const float* d;     // (H,)
  const float* init;  // (B, H, N, P) contiguous, or null for zeros
  void* y;            // (B, S, H, P) contiguous, x's type
  float* state;       // (B, H, N, P) contiguous
  int seq, heads, groups, n, p, chunk;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
};

// Offsets (in floats) of the dynamic shared-memory regions.
struct Layout {
  int ldn, ldp, ldl, strip;
  int bs, cs, xs, st, ws, cum, dts, u, total;
};

__host__ __device__ inline Layout make_layout(int chunk, int n, int p) {
  Layout s;
  s.ldn = n + 4;
  s.ldp = p + 4;
  s.ldl = chunk + 4;
  s.strip = chunk < STRIP ? chunk : STRIP;
  s.bs = 0;                            // B    [L][ldn]
  s.cs = s.bs + chunk * s.ldn;         // C    [L][ldn]
  s.xs = s.cs + chunk * s.ldn;         // X    [L][ldp]
  s.st = s.xs + chunk * s.ldp;         // state [N][ldp]
  s.ws = s.st + n * s.ldp;             // weight strip [strip][ldl]
  s.cum = s.ws + s.strip * s.ldl;      // cumsum of a * dt [L]
  s.dts = s.cum + chunk;               // dt [L]
  s.u = s.dts + chunk;                 // exp(total - cum) * dt [L]
  s.total = s.u + chunk;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) ssd_fwd(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay = make_layout(a.chunk, a.n, a.p);
  const int L = a.chunk;
  const int N = a.n;
  const int P = a.p;
  float* Bs = smem + lay.bs;
  float* Cs = smem + lay.cs;
  float* Xs = smem + lay.xs;
  float* St = smem + lay.st;
  float* Ws = smem + lay.ws;
  float* cum = smem + lay.cum;
  float* dts = smem + lay.dts;
  float* u = smem + lay.u;

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / a.heads;
  const int h = blockIdx.x % a.heads;
  const int g = h / (a.heads / a.groups);
  const T* xg = static_cast<const T*>(a.x) + bi * a.x_sb + h * a.x_sh;
  const float* dtg = a.dt + bi * a.dt_sb + h * a.dt_sh;
  const T* bg = static_cast<const T*>(a.b) + bi * a.b_sb + g * a.b_sg;
  const T* cg = static_cast<const T*>(a.c) + bi * a.c_sb + g * a.c_sg;
  const long long y_ss = (long long)a.heads * P;
  T* yg = static_cast<T*>(a.y) + (long long)bi * a.seq * y_ss + h * P;
  const long long st_off = ((long long)bi * a.heads + h) * N * P;
  const float a_h = a.a[h];
  const float d_h = a.d[h];

  for (int idx = tid; idx < N * P; idx += THREADS) {
    St[(idx / P) * lay.ldp + idx % P] = a.init ? a.init[st_off + idx] : 0.f;
  }

  for (int c0 = 0; c0 < a.seq; c0 += L) {
    const int rows = min(L, a.seq - c0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int l = tid; l < L; l += THREADS) {
      dts[l] = l < rows ? dtg[(long long)(c0 + l) * a.dt_ss] : 0.f;
    }
    for (int idx = tid; idx < L * N; idx += THREADS) {
      const int l = idx / N;
      const int n = idx % N;
      const long long s = c0 + l;
      const bool in = l < rows;
      Bs[l * lay.ldn + n] = in ? to_f32(bg[s * a.b_ss + n]) : 0.f;
      Cs[l * lay.ldn + n] = in ? to_f32(cg[s * a.c_ss + n]) : 0.f;
    }
    for (int idx = tid; idx < L * P; idx += THREADS) {
      const int l = idx / P;
      const int p = idx % P;
      Xs[l * lay.ldp + p] =
          l < rows ? to_f32(xg[(long long)(c0 + l) * a.x_ss + p]) : 0.f;
    }
    __syncthreads();

    // inclusive cumsum of a_h * dt over the chunk: one warp, 32 rows a step
    if (tid < 32) {
      float carry = 0.f;
      for (int base = 0; base < L; base += 32) {
        const int l = base + tid;
        float v = l < L ? a_h * dts[l] : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float t = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += t;
        }
        v += carry;
        if (l < L) cum[l] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float total = cum[L - 1];
    for (int l = tid; l < L; l += THREADS) u[l] = expf(total - cum[l]) * dts[l];

    for (int i0 = 0; i0 < rows; i0 += lay.strip) {
      const int rr = min(lay.strip, L - i0);
      const int ncol = i0 + rr;  // columns right of the strip are masked

      // (1) weight strip: W[r][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for
      // j <= i = i0 + r, else 0.  A thread takes rows tr + rstep k and
      // columns tc + cstep k, so neighbouring lanes read neighbouring B rows.
      {
        const int rstep = rr / 4;
        const int cstep = ncol / 4;
        for (int t = tid; t < rstep * cstep; t += THREADS) {
          const int tr = t / cstep;
          const int tc = t % cstep;
          float acc[4][4] = {};
          for (int n = 0; n < N; n += 4) {
            float4 cv[4];
            float4 bv[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              cv[k] = *reinterpret_cast<const float4*>(
                  &Cs[(i0 + tr + rstep * k) * lay.ldn + n]);
              bv[k] = *reinterpret_cast<const float4*>(
                  &Bs[(tc + cstep * k) * lay.ldn + n]);
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                acc[r][q] += cv[r].x * bv[q].x + cv[r].y * bv[q].y +
                             cv[r].z * bv[q].z + cv[r].w * bv[q].w;
              }
            }
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + tr + rstep * r;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int j = tc + cstep * q;
              Ws[(tr + rstep * r) * lay.ldl + j] =
                  j <= i ? acc[r][q] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
            }
          }
        }
      }
      __syncthreads();

      // (2) the strip's rows of y: W @ X, plus exp(cum_i) (C_i @ state) and
      // the D skip.  A thread takes rows tr and tr + rstep, 4 columns.
      {
        const int rstep = rr / 2;
        const int cstep = P / 4;
        for (int t = tid; t < rstep * cstep; t += THREADS) {
          const int tr = t / cstep;
          const int p0 = (t % cstep) * 4;
          float4 intra[2] = {};
          float4 inter[2] = {};
          for (int j = 0; j < ncol; ++j) {
            const float4 xv =
                *reinterpret_cast<const float4*>(&Xs[j * lay.ldp + p0]);
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              fma4(intra[k], Ws[(tr + rstep * k) * lay.ldl + j], xv);
            }
          }
          for (int n = 0; n < N; ++n) {
            const float4 sv =
                *reinterpret_cast<const float4*>(&St[n * lay.ldp + p0]);
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              fma4(inter[k], Cs[(i0 + tr + rstep * k) * lay.ldn + n], sv);
            }
          }
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int i = i0 + tr + rstep * k;
            if (i >= rows) continue;
            const float e = expf(cum[i]);
            const float4 xv =
                *reinterpret_cast<const float4*>(&Xs[i * lay.ldp + p0]);
            T* yr = yg + (long long)(c0 + i) * y_ss + p0;
            yr[0] = from_f32<T>(intra[k].x + e * inter[k].x + d_h * xv.x);
            yr[1] = from_f32<T>(intra[k].y + e * inter[k].y + d_h * xv.y);
            yr[2] = from_f32<T>(intra[k].z + e * inter[k].z + d_h * xv.z);
            yr[3] = from_f32<T>(intra[k].w + e * inter[k].w + d_h * xv.w);
          }
        }
      }
      __syncthreads();  // the next strip overwrites W; (3) rewrites state
    }

    // (3) state = exp(total) state + (B * u)^T @ X, u_j = exp(total-cum_j) dt_j.
    // A thread takes state rows tn + nstep k (k < 8) and 4 columns.
    {
      const float et = expf(total);
      const int nstep = N / 8;
      const int cstep = P / 4;
      for (int t = tid; t < nstep * cstep; t += THREADS) {
        const int tn = t / cstep;
        const int p0 = (t % cstep) * 4;
        float4 acc[8] = {};
        for (int j = 0; j < rows; ++j) {  // rows past S inject nothing
          float4 xv = *reinterpret_cast<const float4*>(&Xs[j * lay.ldp + p0]);
          const float uj = u[j];
          xv.x *= uj;
          xv.y *= uj;
          xv.z *= uj;
          xv.w *= uj;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            fma4(acc[k], Bs[j * lay.ldn + tn + nstep * k], xv);
          }
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float4* sp =
              reinterpret_cast<float4*>(&St[(tn + nstep * k) * lay.ldp + p0]);
          float4 s = *sp;
          s.x = et * s.x + acc[k].x;
          s.y = et * s.y + acc[k].y;
          s.z = et * s.z + acc[k].z;
          s.w = et * s.w + acc[k].w;
          *sp = s;
        }
      }
    }
  }

  __syncthreads();
  for (int idx = tid; idx < N * P; idx += THREADS) {
    a.state[st_off + idx] = St[(idx / P) * lay.ldp + idx % P];
  }
}

template <typename T>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  const Layout lay = make_layout(a.chunk, a.n, a.p);
  const int bytes = static_cast<int>(sizeof(float)) * lay.total;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  ssd_fwd<T><<<batch * a.heads, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype of x/B/C/y: 0 = float32, 1 = bfloat16.  dt, a, d, init and state
// are float32.  Requires chunk % 4 == 0, n % 8 == 0, p % 4 == 0 and
// heads % groups == 0 (the wrapper checks).  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int repro_ssd_fwd(
    int dtype, const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* d, const void* init, void* y, void* state,
    int batch, int seq, int heads, int groups, int n, int p, int chunk,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg, void* stream) {
  Args args{x, static_cast<const float*>(dt), static_cast<const float*>(a),
            b, c, static_cast<const float*>(d),
            static_cast<const float*>(init), y, static_cast<float*>(state),
            seq, heads, groups, n, p, chunk,
            x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
            b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(args, batch, st);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(args, batch, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
