// bench_native.cpp — native forward-mode AD benchmark + C ABI for ctypes.
//
// The reference calibrates its AD engine with C++ dual-number benchmarks on
// the ackley and rosenbrock gradients (SURVEY §2.9). This file provides the
// JAX build's native comparator: chunked Dual<N> gradients timed with
// std::chrono, exported through a plain C interface consumed by
// hank_tpu/utils/native.py. Run standalone:  make && ./bench_native
//
// Correctness is cross-checked against jax.jacfwd in tests/test_native.py.

#include <chrono>
#include <cstdio>
#include <vector>

#include "dual.hpp"

namespace {

using hank_native::Dual;

// f(x) = ackley function, generic over scalar type.
template <typename T>
T ackley(const T* x, std::size_t n) {
  const double a = 20.0, b = 0.2, c = 2.0 * M_PI;
  T sum_sq(0.0), sum_cos(0.0);
  for (std::size_t i = 0; i < n; ++i) {
    sum_sq = sum_sq + x[i] * x[i];
    sum_cos = sum_cos + cos(c * x[i]);
  }
  const double inv_n = 1.0 / static_cast<double>(n);
  return 0.0 - a * exp((0.0 - b) * sqrt(sum_sq * inv_n)) - exp(sum_cos * inv_n)
         + (a + std::exp(1.0));
}

template <typename T>
T rosenbrock(const T* x, std::size_t n) {
  T out(0.0);
  for (std::size_t i = 0; i + 1 < n; ++i) {
    const T t1 = 1.0 - x[i];
    const T t2 = x[i + 1] - x[i] * x[i];
    out = out + t1 * t1 + 100.0 * (t2 * t2);
  }
  return out;
}

double now_seconds() {
  using clock = std::chrono::steady_clock;
  return std::chrono::duration<double>(clock::now().time_since_epoch()).count();
}

}  // namespace

extern "C" {

// Gradient entries with a fixed chunk width (mirrors the reference suite's
// 1..5-epsilon variants through one template).
#define DEFINE_GRAD(NAME, FN)                                              \
  void NAME##_grad_chunk1(const double* x, double* g, int n) {             \
    hank_native::gradient<1>([](const Dual<1>* xs, std::size_t m) {        \
      return FN(xs, m); }, x, g, static_cast<std::size_t>(n));             \
  }                                                                        \
  void NAME##_grad_chunk4(const double* x, double* g, int n) {             \
    hank_native::gradient<4>([](const Dual<4>* xs, std::size_t m) {        \
      return FN(xs, m); }, x, g, static_cast<std::size_t>(n));             \
  }                                                                        \
  void NAME##_grad_chunk8(const double* x, double* g, int n) {             \
    hank_native::gradient<8>([](const Dual<8>* xs, std::size_t m) {        \
      return FN(xs, m); }, x, g, static_cast<std::size_t>(n));             \
  }                                                                        \
  double NAME##_value(const double* x, int n) {                            \
    return FN(x, static_cast<std::size_t>(n));                             \
  }

DEFINE_GRAD(ackley, ackley)
DEFINE_GRAD(rosenbrock, rosenbrock)

// Timed benchmark: returns seconds per gradient evaluation.
double bench_gradient(const char* which, int chunk, int n, int iters) {
  std::vector<double> x(n), g(n);
  for (int i = 0; i < n; ++i) x[i] = 0.1 + 0.8 * i / n;
  void (*fn)(const double*, double*, int) = nullptr;
  const bool ack = which[0] == 'a';
  if (chunk == 1) fn = ack ? ackley_grad_chunk1 : rosenbrock_grad_chunk1;
  else if (chunk == 4) fn = ack ? ackley_grad_chunk4 : rosenbrock_grad_chunk4;
  else fn = ack ? ackley_grad_chunk8 : rosenbrock_grad_chunk8;
  fn(x.data(), g.data(), n);  // warm up
  const double t0 = now_seconds();
  for (int it = 0; it < iters; ++it) fn(x.data(), g.data(), n);
  return (now_seconds() - t0) / iters;
}

}  // extern "C"

int main() {
  for (const char* which : {"ackley", "rosenbrock"}) {
    for (int n : {10, 100, 1000}) {
      for (int chunk : {1, 4, 8}) {
        const double s = bench_gradient(which, chunk, n, 1000);
        std::printf("%-10s n=%-5d chunk=%d  %10.3f us/grad\n",
                    which, n, chunk, s * 1e6);
      }
    }
  }
  return 0;
}
