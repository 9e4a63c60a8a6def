// dual.hpp — forward-mode dual numbers with a compile-time partials width.
//
// Native benchmarking companion to hank_tpu's JAX forward-mode sweeps: the
// reference ships a C++ dual-number micro-benchmark suite
// (ForwardDiff.jl/benchmarks/cpp, SURVEY §2.9) to calibrate its AD engine
// against hand-rolled native code; this is the equivalent for the JAX build,
// written as a single templated class (Dual<N>) with chunked seeding in the
// gradient driver rather than per-width classes.
//
// Used by bench_native.cpp (ackley / rosenbrock gradients) and exported to
// Python through a C ABI (native.py, ctypes).

#pragma once

#include <array>
#include <cmath>
#include <cstddef>
#include <vector>

namespace hank_native {

template <std::size_t N>
struct Dual {
  double v;                   // primal value
  std::array<double, N> d;    // partial derivatives

  Dual() : v(0.0), d{} {}
  explicit Dual(double value) : v(value), d{} {}
  Dual(double value, const std::array<double, N>& partials) : v(value), d(partials) {}

  static Dual seeded(double value, std::size_t k) {
    Dual out(value);
    out.d[k] = 1.0;
    return out;
  }
};

// ── arithmetic ───────────────────────────────────────────────────────────────

template <std::size_t N>
inline Dual<N> operator+(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> out(a.v + b.v);
  for (std::size_t i = 0; i < N; ++i) out.d[i] = a.d[i] + b.d[i];
  return out;
}

template <std::size_t N>
inline Dual<N> operator-(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> out(a.v - b.v);
  for (std::size_t i = 0; i < N; ++i) out.d[i] = a.d[i] - b.d[i];
  return out;
}

template <std::size_t N>
inline Dual<N> operator*(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> out(a.v * b.v);
  for (std::size_t i = 0; i < N; ++i) out.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return out;
}

template <std::size_t N>
inline Dual<N> operator/(const Dual<N>& a, const Dual<N>& b) {
  const double inv = 1.0 / b.v;
  Dual<N> out(a.v * inv);
  for (std::size_t i = 0; i < N; ++i)
    out.d[i] = (a.d[i] - out.v * b.d[i]) * inv;
  return out;
}

template <std::size_t N> inline Dual<N> operator+(const Dual<N>& a, double c) { Dual<N> o = a; o.v += c; return o; }
template <std::size_t N> inline Dual<N> operator+(double c, const Dual<N>& a) { return a + c; }
template <std::size_t N> inline Dual<N> operator-(const Dual<N>& a, double c) { Dual<N> o = a; o.v -= c; return o; }
template <std::size_t N> inline Dual<N> operator-(double c, const Dual<N>& a) {
  Dual<N> o(c - a.v);
  for (std::size_t i = 0; i < N; ++i) o.d[i] = -a.d[i];
  return o;
}
template <std::size_t N> inline Dual<N> operator*(const Dual<N>& a, double c) {
  Dual<N> o(a.v * c);
  for (std::size_t i = 0; i < N; ++i) o.d[i] = a.d[i] * c;
  return o;
}
template <std::size_t N> inline Dual<N> operator*(double c, const Dual<N>& a) { return a * c; }

// ── elementary functions (chain rule) ────────────────────────────────────────

template <std::size_t N>
inline Dual<N> sin(const Dual<N>& a) {
  Dual<N> out(std::sin(a.v));
  const double c = std::cos(a.v);
  for (std::size_t i = 0; i < N; ++i) out.d[i] = c * a.d[i];
  return out;
}

template <std::size_t N>
inline Dual<N> cos(const Dual<N>& a) {
  Dual<N> out(std::cos(a.v));
  const double s = -std::sin(a.v);
  for (std::size_t i = 0; i < N; ++i) out.d[i] = s * a.d[i];
  return out;
}

template <std::size_t N>
inline Dual<N> exp(const Dual<N>& a) {
  const double e = std::exp(a.v);
  Dual<N> out(e);
  for (std::size_t i = 0; i < N; ++i) out.d[i] = e * a.d[i];
  return out;
}

template <std::size_t N>
inline Dual<N> sqrt(const Dual<N>& a) {
  const double s = std::sqrt(a.v);
  Dual<N> out(s);
  const double g = 0.5 / s;
  for (std::size_t i = 0; i < N; ++i) out.d[i] = g * a.d[i];
  return out;
}

template <std::size_t N>
inline Dual<N> pow(const Dual<N>& a, double p) {
  Dual<N> out(std::pow(a.v, p));
  const double g = p * std::pow(a.v, p - 1.0);
  for (std::size_t i = 0; i < N; ++i) out.d[i] = g * a.d[i];
  return out;
}

// ── chunked gradient driver ──────────────────────────────────────────────────
//
// Seeds at most N inputs per pass (the chunk), sweeping the function once per
// chunk — the same chunking strategy as hank_tpu's vmapped JVP column sweeps
// (and the reference AD engine's Chunk mode).

template <std::size_t N, typename F>
void gradient(F&& f, const double* x, double* grad, std::size_t n) {
  std::array<Dual<N>, 64> buf;  // small-input fast path uses stack storage
  std::vector<Dual<N>> heap;
  Dual<N>* xs;
  if (n <= buf.size()) {
    xs = buf.data();
  } else {
    heap.resize(n);
    xs = heap.data();
  }
  for (std::size_t chunk = 0; chunk < n; chunk += N) {
    const std::size_t width = (chunk + N <= n) ? N : (n - chunk);
    for (std::size_t i = 0; i < n; ++i) xs[i] = Dual<N>(x[i]);
    for (std::size_t k = 0; k < width; ++k) xs[chunk + k].d[k] = 1.0;
    const Dual<N> out = f(xs, n);
    for (std::size_t k = 0; k < width; ++k) grad[chunk + k] = out.d[k];
  }
}

}  // namespace hank_native
