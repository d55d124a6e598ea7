// The general ff.fusion Program executor: one recorded chain of FF and f32
// elementwise ops over broadcast operands, with optional trailing
// compensated row sums, evaluated in one launch.
//
// Replaces the TPU kernel src/repro/kernels/ff_fused.py::run_pallas (its
// kernel closure with _eval_instrs, _lane_cascade and _fold_lanes), which
// generates a kernel per Program.  This one is fixed: the Program rides in
// the launch parameters as an instruction tape (op code, argument ids, an
// immediate per instruction), with each operand plane's address and its
// (row, column) strides, 0 along a dimension it broadcasts over.  Each
// thread evaluates the tape for one element into a value file of at most
// kMaxInstrs FF values; the wrapper (kernels/ff_fused.py run_program)
// refuses a longer Program.
//
// What bounds it on this card: a chain reads each operand plane once and
// writes each output plane once; at a few to a few tens of f32
// instructions per element (axpy: Mul212 + Add22, 18 instructions for 24
// bytes) memory bounds it, and a chain with a deep op (exp22, log22,
// tanh22, sigmoid22: ~150-400 instructions) is bound by instructions.
// The tape walk adds a switch per instruction and keeps the value file in
// local memory (L1): correct first, specialised code per Program later.
//
// Two launch shapes:
//   * no rowsum output: a grid-stride loop over the R x C elements;
//   * a rowsum output: one block per row and 128 threads, thread l playing
//     TPU lane l: it evaluates columns l, l+128, ... in order, writes the
//     elementwise outputs, and folds each rowsum value, masked past the
//     value's own width, into its (s, c, cc) Neumaier accumulators; thread
//     0 then folds the 128 lanes in lane order.  That is the TPU kernel's
//     summation order, so the result is its plain version's bits.
// Every op is the explicitly rounded op sequence of ff_eft.cuh, so each
// element is the plain version's bits (fexp/flog: the card's expf/logf,
// as torch.exp/torch.log on the card).

#include "ff_eft.cuh"

namespace {

constexpr int kMaxInstrs = 64, kMaxPlanes = 32, kMaxOuts = 16;
using ffk::kLanes;

// Same order as PROGRAM_OPS in kernels/ff_fused.py.
enum Op : int {
  LEAF_FF, LEAF_F32, CONST, FADD, FSUB, FMUL, FDIV, FNEG, FSQRT, FEXP, FLOG,
  ADD22, ADD212, MUL22, MUL212, DIV22, SQRT22, FMA22, NEG22, EXP22, LOG22,
  TANH22, SIGMOID22, LIFT, HI, LO, PACK, ROWSUM
};
enum OutKind : int { OUT_F32 = 0, OUT_FF = 1, OUT_RED = 2 };

struct Instr {
  int op;
  int a[3];     // argument value ids; a leaf's plane indices
  float imm;    // a const's value
};

// Mirrored by _Tape in kernels/ff_fused.py (checked through
// ff_program_tape_bytes at the first launch).
struct Tape {
  int n_instr, n_out;
  long long rows, cols;
  Instr ins[kMaxInstrs];
  const float* plane[kMaxPlanes];
  long long rs[kMaxPlanes], cs[kMaxPlanes];   // element strides, 0: bcast
  int out_id[kMaxOuts], out_kind[kMaxOuts];
  long long red_width[kMaxOuts];              // a rowsum's value width
  float* out_hi[kMaxOuts];
  float* out_lo[kMaxOuts];
};

using ffk::ff2;

// The deep ops stay out of line: one copy each in the switch.
__device__ __noinline__ ff2 op_exp22(float h, float l) { return ffk::exp22(h, l); }
__device__ __noinline__ ff2 op_log22(float h, float l) { return ffk::log22(h, l); }
__device__ __noinline__ ff2 op_tanh22(float h, float l) { return ffk::tanh22(h, l); }
__device__ __noinline__ ff2 op_sigmoid22(float h, float l) {
  return ffk::sigmoid22(h, l);
}

__device__ __forceinline__ float load(const Tape& t, int p, long long r,
                                      long long c) {
  return t.plane[p][r * t.rs[p] + c * t.cs[p]];
}

// Evaluate the tape at element (r, c) into the value file (vh, vl); a
// rowsum's slot is left unset (its caller reduces the argument's value).
__device__ void eval_tape(const Tape& t, long long r, long long c,
                          float* vh, float* vl) {
  using namespace ffk;
  for (int i = 0; i < t.n_instr; ++i) {
    const Instr& in = t.ins[i];
    const int a = in.a[0], b = in.a[1], d = in.a[2];
    ff2 v = {0.0f, 0.0f};
    switch (in.op) {
      case LEAF_FF: v = {load(t, a, r, c), load(t, b, r, c)}; break;
      case LEAF_F32: v.hi = load(t, a, r, c); break;
      case CONST: v.hi = in.imm; break;
      case FADD: v.hi = add(vh[a], vh[b]); break;
      case FSUB: v.hi = sub(vh[a], vh[b]); break;
      case FMUL: v.hi = mul(vh[a], vh[b]); break;
      case FDIV: v.hi = dvd(vh[a], vh[b]); break;
      case FNEG: v.hi = -vh[a]; break;
      case FSQRT: v.hi = __fsqrt_rn(vh[a]); break;
      case FEXP: v.hi = expf(vh[a]); break;
      case FLOG: v.hi = logf(vh[a]); break;
      case ADD22: v = add22({vh[a], vl[a]}, {vh[b], vl[b]}); break;
      case ADD212: v = add212({vh[a], vl[a]}, vh[b]); break;
      case MUL22: v = mul22({vh[a], vl[a]}, {vh[b], vl[b]}); break;
      case MUL212: v = mul212({vh[a], vl[a]}, vh[b]); break;
      case DIV22: v = div22({vh[a], vl[a]}, {vh[b], vl[b]}); break;
      case SQRT22: v = sqrt22({vh[a], vl[a]}); break;
      case FMA22:
        v = fma22({vh[a], vl[a]}, {vh[b], vl[b]}, {vh[d], vl[d]});
        break;
      case NEG22: v = {-vh[a], -vl[a]}; break;
      case EXP22: v = op_exp22(vh[a], vl[a]); break;
      case LOG22: v = op_log22(vh[a], vl[a]); break;
      case TANH22: v = op_tanh22(vh[a], vl[a]); break;
      case SIGMOID22: v = op_sigmoid22(vh[a], vl[a]); break;
      case LIFT: v.hi = vh[a]; break;
      case HI: v.hi = vh[a]; break;
      case LO: v.hi = vl[a]; break;
      case PACK: v = {vh[a], vh[b]}; break;
      default: break;   // ROWSUM: reduced by the caller
    }
    vh[i] = v.hi;
    vl[i] = v.lo;
  }
}

__device__ __forceinline__ void write_outputs(const Tape& t, long long idx,
                                              const float* vh,
                                              const float* vl) {
  for (int o = 0; o < t.n_out; ++o) {
    if (t.out_kind[o] == OUT_RED) continue;
    const int id = t.out_id[o];
    t.out_hi[o][idx] = vh[id];
    if (t.out_kind[o] == OUT_FF) t.out_lo[o][idx] = vl[id];
  }
}

__global__ void __launch_bounds__(256)
program_elementwise(const __grid_constant__ Tape t) {
  float vh[kMaxInstrs], vl[kMaxInstrs];
  const long long n = t.rows * t.cols;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const long long r = i / t.cols;
    eval_tape(t, r, i - r * t.cols, vh, vl);
    write_outputs(t, i, vh, vl);
  }
}

__global__ void __launch_bounds__(kLanes)
program_rows(const __grid_constant__ Tape t) {
  using namespace ffk;
  float vh[kMaxInstrs], vl[kMaxInstrs];
  LaneSum acc[kMaxOuts];
  const long long r = blockIdx.x;
  const int lane = threadIdx.x;
  for (long long j = lane; j < t.cols; j += kLanes) {
    eval_tape(t, r, j, vh, vl);
    write_outputs(t, r * t.cols + j, vh, vl);
    for (int o = 0; o < t.n_out; ++o) {
      if (t.out_kind[o] != OUT_RED) continue;
      // masked past the value's own width: padding and column-broadcast
      // copies add zero, as on the TPU
      acc[o].add(j < t.red_width[o] ? vh[t.ins[t.out_id[o]].a[0]] : 0.0f);
    }
  }
  __shared__ float sh[3 * kLanes + 2];
  for (int o = 0; o < t.n_out; ++o) {
    if (t.out_kind[o] != OUT_RED) continue;
    const ff2 f = fold_lanes(acc[o], sh);
    if (lane == 0) {
      t.out_hi[o][r] = f.hi;
      t.out_lo[o][r] = f.lo;
    }
  }
}

}  // namespace

// The size of struct Tape, which the Python wrapper mirrors.
extern "C" int ff_program_tape_bytes() { return sizeof(Tape); }

// tape: a struct Tape (the Program and its operand and output planes) in
// host memory, copied into the launch parameters; passed untyped because
// Tape has internal linkage.  Returns the CUDA error of the launch (0 on
// success).
extern "C" int ff_program_f32(const void* tape_ptr, cudaStream_t stream) {
  const Tape* tape = static_cast<const Tape*>(tape_ptr);
  const long long n = tape->rows * tape->cols;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  bool rows = false;
  for (int o = 0; o < tape->n_out; ++o) rows |= tape->out_kind[o] == OUT_RED;
  if (rows) {
    program_rows<<<static_cast<unsigned>(tape->rows), kLanes, 0, stream>>>(
        *tape);
    return static_cast<int>(cudaGetLastError());
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + 255) / 256;
  const long long cap = static_cast<long long>(sms) * 8;
  const int grid = static_cast<int>(blocks < cap ? blocks : cap);
  program_elementwise<<<grid, 256, 0, stream>>>(*tape);
  return static_cast<int>(cudaGetLastError());
}
