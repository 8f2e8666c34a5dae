
// ---- appended to csrc/osd_eliminate.cu by tests/test_torch_osd_emulated.py
// Reads the batch (int32), g [71, 255] uint8 and perm [batch, 255] int64
// from argv[1]; runs the kernel one block a header; writes the reduced
// matrices [batch, 71, 255] uint8 and the pivots [batch, 71] int64 to
// argv[2].
#include <cstdio>

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  FILE* in = fopen(argv[1], "rb");
  if (!in) return 2;
  int batch = 0;
  if (fread(&batch, 4, 1, in) != 1 || batch <= 0) return 2;
  std::vector<uint8_t> g(size_t(kK) * kN);
  std::vector<int64_t> perm(size_t(batch) * kN);
  if (fread(g.data(), 1, g.size(), in) != g.size() ||
      fread(perm.data(), 8, perm.size(), in) != perm.size()) {
    return 2;
  }
  fclose(in);
  std::vector<uint8_t> red(size_t(batch) * kK * kN);
  std::vector<int64_t> piv(size_t(batch) * kK);
  for (int b = 0; b < batch; ++b) {
    emu_block(32, b, [&] {
      osd_eliminate_kernel(g.data(), perm.data(), red.data(), piv.data());
    });
  }
  FILE* out = fopen(argv[2], "wb");
  if (!out) return 2;
  fwrite(red.data(), 1, red.size(), out);
  fwrite(piv.data(), 8, piv.size(), out);
  fclose(out);
  return 0;
}
