// Native FASTA codec: scan + encode a FASTA byte buffer into the framework's
// tensor layout (int8 codes [N, L_max], int32 lens, header byte ranges).
//
// Native-runtime counterpart of the reference's C++ data loader
// (src/init/SequenceSet.{h,cpp} / Sequence.{h,cpp}): the reference parses
// FASTA into per-sequence C++ objects; here the target layout is the padded
// device tensor consumed by the JAX programs, produced in one pass
// over the raw bytes.  Exposed as a tiny C ABI consumed via ctypes
// (bammmotif2_tpu/io/native.py); the pure-numpy parser in utils/fasta.py is
// the behavioral reference and fallback.
//
// Parsing semantics (must match utils/fasta.py::_parse_fasta_text):
//   * lines separated by '\n' or '\r' (universal newlines: "\r\n", lone
//     '\r', and '\n' all break lines, like Python text-mode reads);
//     leading/trailing ASCII whitespace stripped
//   * empty lines skipped
//   * '>' starts a new record; header = rest of line, stripped
//   * ';' lines are old-style FASTA comments, skipped
//   * data before any header opens an implicit "unnamed" record
//   * sequence letters encode through a caller-supplied 256-entry table
//     (alphabet-generic: STANDARD, METHYLC, ...); unknown -> AMBIG code
//
// Build: g++ -O3 -shared -fPIC fasta_codec.cpp -o libbamm_fasta.so
// (compiled on demand by io/native.py; ships inside the package)

#include <cstdint>
#include <cstring>

namespace {

inline bool is_space(uint8_t c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '\v' ||
         c == '\f';
}

// Iterate stripped, non-empty lines of buf[0..n); calls fn(start, end).
// Both '\n' and '\r' end a line (universal newlines); the empty line
// between a "\r\n" pair strips to nothing and is skipped.
template <typename F>
inline void for_each_line(const uint8_t* buf, int64_t n, F&& fn) {
  int64_t i = 0;
  while (i < n) {
    int64_t j = i;
    while (j < n && buf[j] != '\n' && buf[j] != '\r') ++j;
    int64_t a = i, b = j;
    while (a < b && is_space(buf[a])) ++a;
    while (b > a && is_space(buf[b - 1])) --b;
    if (b > a) fn(a, b);
    i = j + 1;
  }
}

}  // namespace

extern "C" {

// Pass 1: count records and the maximum concatenated sequence length.
// Returns 0 on success.  A buffer with data before any '>' counts an
// implicit leading record.
int bamm_fasta_scan(const uint8_t* buf, int64_t n, int64_t* n_seqs,
                    int64_t* max_len) {
  int64_t count = 0, cur = -1, mx = 0;
  for_each_line(buf, n, [&](int64_t a, int64_t b) {
    if (buf[a] == '>') {
      ++count;
      cur = 0;
    } else if (buf[a] == ';') {
      // comment
    } else {
      if (cur < 0) {  // headerless leading data
        ++count;
        cur = 0;
      }
      cur += b - a;
      if (cur > mx) mx = cur;
    }
  });
  *n_seqs = count;
  *max_len = mx;
  return 0;
}

// Pass 2: fill the padded code matrix and metadata.
//   table256: letter byte -> int8 code (AMBIG for unknown letters)
//   codes:    int8 [n_seqs, l_max], written fully (pad beyond each length)
//   lens:     int32 [n_seqs]
//   hdr_off/hdr_len: byte range of each header in buf; off = -1 for the
//                    implicit "unnamed" record
// Returns the number of records written (== n_seqs from scan), or -1 if
// the provided geometry is exceeded (concurrent file change).
int64_t bamm_fasta_fill(const uint8_t* buf, int64_t n,
                        const int8_t* table256, int8_t* codes, int64_t n_seqs,
                        int64_t l_max, int32_t* lens, int64_t* hdr_off,
                        int64_t* hdr_len, int8_t pad) {
  if (n_seqs > 0 && l_max > 0) {
    memset(codes, static_cast<unsigned char>(pad),
           static_cast<size_t>(n_seqs) * static_cast<size_t>(l_max));
  }
  int64_t rec = -1;
  int64_t len = 0;
  bool overflow = false;
  for_each_line(buf, n, [&](int64_t a, int64_t b) {
    if (overflow) return;
    if (buf[a] == '>') {
      if (rec >= 0) lens[rec] = static_cast<int32_t>(len);
      ++rec;
      len = 0;
      if (rec >= n_seqs) {
        overflow = true;
        return;
      }
      int64_t ha = a + 1, hb = b;
      while (ha < hb && is_space(buf[ha])) ++ha;
      hdr_off[rec] = ha;
      hdr_len[rec] = hb - ha;
    } else if (buf[a] == ';') {
      // comment
    } else {
      if (rec < 0) {
        ++rec;
        len = 0;
        if (rec >= n_seqs) {
          overflow = true;
          return;
        }
        hdr_off[rec] = -1;
        hdr_len[rec] = 0;
      }
      int64_t m = b - a;
      if (len + m > l_max) {
        overflow = true;
        return;
      }
      int8_t* dst = codes + rec * l_max + len;
      for (int64_t t = 0; t < m; ++t) dst[t] = table256[buf[a + t]];
      len += m;
    }
  });
  if (overflow) return -1;
  if (rec >= 0) lens[rec] = static_cast<int32_t>(len);
  return rec + 1;
}

// Reverse-complement a padded code batch in place of a separate output:
//   out[i, t] = comp[codes[i, lens[i]-1-t]] for t < lens[i], pad after.
// comp: size-table of |A| complement codes; AMBIG (<0) maps to AMBIG.
void bamm_revcomp_batch(const int8_t* codes, const int32_t* lens,
                        int64_t n_seqs, int64_t l_max, const int8_t* comp,
                        int64_t comp_size, int8_t ambig, int8_t pad,
                        int8_t* out) {
  for (int64_t i = 0; i < n_seqs; ++i) {
    const int8_t* src = codes + i * l_max;
    int8_t* dst = out + i * l_max;
    const int64_t L = lens[i];
    for (int64_t t = 0; t < L; ++t) {
      int8_t c = src[L - 1 - t];
      dst[t] = (c >= 0 && c < comp_size) ? comp[c] : ambig;
    }
    for (int64_t t = L; t < l_max; ++t) dst[t] = pad;
  }
}

}  // extern "C"
