
// ---- appended to csrc/scl_decode.cu by tests/test_torch_scl_emulated.py
// Reads a header of 14 int32 (L, exact, rank, f32, n_rows, code_len,
// d0_len, llr_lo, beta_lo, s_llr_len, s_beta_len, out_off, n_depths,
// batch), the packed rows (pack_list_rows) and the LLRs from argv[1];
// runs the kernel one block a frame; writes the codewords [batch, L, n]
// uint8 and the path metrics [batch, L] f32 to argv[2].
#include <cstdio>

template <int L, bool kExact, bool kRank, typename BetaT>
void emu_run(const int* hdr, const uint4* rows, const float* llrs,
             uint8_t* cw, float* pm) {
  const Geom g{hdr[5], hdr[6], hdr[7],  hdr[8],
               hdr[9], hdr[10], hdr[11], hdr[12]};
  const int batch = hdr[13];
  std::vector<float> gl(size_t(batch) * L * (g.llr_lo - g.d0_len) + 1);
  std::vector<BetaT> gb(size_t(batch) * L * g.beta_lo + 1);
  for (int b = 0; b < batch; ++b) {
    emu_block(kThreads, b, [&] {
      scl_decode_kernel<L, kExact, kRank, BetaT>(llrs, rows, hdr[4], g,
                                                 gl.data(), gb.data(), cw,
                                                 pm);
    });
  }
}

template <int L>
void emu_list(const int* hdr, const uint4* rows, const float* llrs,
              uint8_t* cw, float* pm) {
  const bool exact = hdr[1], rank = hdr[2], f32 = hdr[3];
  if (f32) {
    if (!exact) emu_run<L, false, false, float>(hdr, rows, llrs, cw, pm);
    else if (rank) emu_run<L, true, true, float>(hdr, rows, llrs, cw, pm);
    else emu_run<L, true, false, float>(hdr, rows, llrs, cw, pm);
  } else {
    if (!exact) emu_run<L, false, false, int8_t>(hdr, rows, llrs, cw, pm);
    else if (rank) emu_run<L, true, true, int8_t>(hdr, rows, llrs, cw, pm);
    else emu_run<L, true, false, int8_t>(hdr, rows, llrs, cw, pm);
  }
}

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  FILE* in = fopen(argv[1], "rb");
  if (!in) return 2;
  int hdr[14];
  if (fread(hdr, 4, 14, in) != 14) return 2;
  std::vector<uint4> rows(size_t(hdr[4] + 1) * 2);
  std::vector<float> llrs(size_t(hdr[13]) * hdr[5]);
  if (fread(rows.data(), 16, rows.size(), in) != rows.size() ||
      fread(llrs.data(), 4, llrs.size(), in) != llrs.size()) {
    return 2;
  }
  fclose(in);
  const int L = hdr[0];
  std::vector<uint8_t> cw(size_t(hdr[13]) * L * hdr[5]);
  std::vector<float> pm(size_t(hdr[13]) * L);
  const auto run_list = L == 2 ? emu_list<2> : L == 4 ? emu_list<4>
                                   : L == 8 ? emu_list<8> : nullptr;
  if (run_list == nullptr) return 2;
  run_list(hdr, rows.data(), llrs.data(), cw.data(), pm.data());
  FILE* out = fopen(argv[2], "wb");
  if (!out) return 2;
  fwrite(cw.data(), 1, cw.size(), out);
  fwrite(pm.data(), 4, pm.size(), out);
  fclose(out);
  return 0;
}
