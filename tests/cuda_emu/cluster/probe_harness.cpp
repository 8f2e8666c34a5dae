
// ---- appended to csrc/probe_p256.cu (with -DPROBE_P256),
// csrc/probe_rank3.cu (with -DPROBE_RANK3) or csrc/probe_interleave.cu by
// tests/test_torch_probes_emulated.py
// argv: the input file (raw f32), the output file, the output's floats,
// then the launch function's int arguments in its order (p256: body, P,
// n, R; rank3: kind, R; interleave: body, n_chains, width, shared,
// in_cols, reps, n).
// Exits with the launch function's return code.
#include <cstdio>
#include <cstdlib>

int main(int argc, char** argv) {
  if (argc < 4) return 100;
  FILE* in = fopen(argv[1], "rb");
  if (!in) return 101;
  std::vector<float> x;
  float v;
  while (fread(&v, 4, 1, in) == 1) x.push_back(v);
  fclose(in);
  std::vector<float> y(static_cast<size_t>(atoi(argv[3])));
  auto arg = [&](int i) { return i < argc ? atoi(argv[i]) : -1; };
#ifdef PROBE_P256
  const int rc = probe_p256_launch(arg(4), x.data(), y.data(), arg(5),
                                   arg(6), arg(7), nullptr);
#elif defined(PROBE_RANK3)
  const int rc = probe_rank3_launch(arg(4), x.data(), y.data(), arg(5),
                                    nullptr);
#else
  const int rc = probe_interleave_launch(arg(4), arg(5), arg(6), arg(7),
                                         x.data(), arg(8), arg(9), y.data(),
                                         arg(10), nullptr);
#endif
  if (rc) return rc;
  FILE* out = fopen(argv[2], "wb");
  if (!out) return 102;
  fwrite(y.data(), 4, y.size(), out);
  fclose(out);
  return 0;
}
