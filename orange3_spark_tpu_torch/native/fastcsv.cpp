// fastcsv — multithreaded CSV -> float32 columnar chunks.
//
// Plays the role of Spark's native ingest substrate (the JVM CSV reader +
// Tungsten columnar memory behind `spark.read.csv`; SURVEY.md §2b "Data
// ingest" — reconstructed, reference mount empty). The TPU framework's hot
// ingest path must keep the host core(s) from becoming the bottleneck
// between disk and `jax.device_put`, so parsing is:
//
//   * chunked: the file is read in large blocks clipped to line boundaries,
//     so a 1B-row file streams through a fixed host-memory window
//     (out-of-core — the NYC-Taxi/Criteo configs never fit in RAM);
//   * parallel: each chunk's rows are split across threads; every thread
//     writes disjoint [row, col] slots of the caller's buffer, no locks;
//   * allocation-free in steady state: the block buffer's capacity is
//     reserved once (sized from the observed bytes/row) and REUSED across
//     chunks — regrowing a vector 4 MB at a time is a quadratic memcpy
//     that single-handedly halves parse throughput on a 1-core host;
//   * a hand-rolled float parser (no strtof locale machinery) fills the
//     row-major float32 buffer the Python side hands in (which is the
//     exact layout device_put wants for P('data', None) sharding).
//
// Categorical columns (fcsv_set_categorical): real Criteo ships hex-string
// categories. Columns marked categorical are not float-parsed; the cell's
// exact bytes (after RFC-4180 unquoting) are crc32-hashed (zlib polynomial,
// so the code equals python's `zlib.crc32(cell)`), masked to 24 bits so the
// value is EXACT in float32 (matching ops/hashing.py strings_to_u32 —
// models checkpoint-port between the host and native on-ramps), and stored
// as that integer's float value. Numeric-looking cells in a categorical
// column hash like any other string — a declared categorical is opaque.
//
// C API only (extern "C") — bound from Python with ctypes; no pybind11.
//
// Dialect: RFC-4180-ish. Quoted cells may contain the delimiter ("" escapes
// a quote); numeric quoted content parses, text becomes NaN (or a crc32
// code in categorical columns). Embedded NEWLINES inside quoted cells are
// NOT supported (the chunker's newline scan is quote-blind by design — it
// is what keeps chunk splitting O(memchr)) — use io/readers.py (pyarrow)
// for such files.

#include <charconv>
#include <limits>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <string>
#include <thread>
#include <vector>

namespace {

struct CsvHandle {
  FILE* f = nullptr;
  char delim = ',';
  std::vector<std::string> colnames;
  int ncols = 0;
  std::vector<uint8_t> is_cat;  // per-column categorical flag
  // carry: bytes of a trailing partial line from the previous block
  std::vector<char> carry;
  // reusable block buffer (capacity persists across chunks)
  std::vector<char> buf;
  std::vector<size_t> starts, ends;
  bool eof = false;
  long rows_read = 0;
  size_t est_row_bytes = 64;  // adapted after the first chunk
};

// ----------------------------------------------------------------- crc32
// zlib-compatible crc32 (poly 0xEDB88320), slicing-by-8: eight lookup
// tables let the hot loop fold 8 input bytes per iteration (~1 cycle/byte
// vs ~5 for the classic byte-table loop — measurable on real Criteo, where
// 26 of 39 cells per row take this path). Codes match python's
// ``zlib.crc32`` byte-for-byte (pinned by tests/test_native_io.py).
struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[0][i] = c;
    }
    for (int k = 1; k < 8; ++k)
      for (uint32_t i = 0; i < 256; ++i)
        t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
  }
};

inline const CrcTables& crc_tables() {
  // C++11 magic static: thread-safe one-time init
  static const CrcTables tables;
  return tables;
}

inline uint32_t crc32_bytes(const char* p, size_t n) {
  const auto& T = crc_tables();
  uint32_t c = 0xFFFFFFFFu;
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= c;
    c = T.t[7][lo & 0xFF] ^ T.t[6][(lo >> 8) & 0xFF]
      ^ T.t[5][(lo >> 16) & 0xFF] ^ T.t[4][lo >> 24]
      ^ T.t[3][hi & 0xFF] ^ T.t[2][(hi >> 8) & 0xFF]
      ^ T.t[1][(hi >> 16) & 0xFF] ^ T.t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  const uint32_t* t0 = T.t[0];
  for (size_t i = 0; i < n; ++i)
    c = t0[(c ^ (uint8_t)p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// 24-bit mask: codes must survive a float32 round-trip exactly
// (ops/hashing.py STRING_CODE_MASK).
constexpr uint32_t kStringCodeMask = 0x00FFFFFF;

// powers of ten for the mantissa/exponent recombination; f32 underflows
// below 1e-45 and overflows above ~3.4e38, so +-60 covers everything a
// float32 output can represent (clamped beyond).
struct Pow10Table {
  double t[121];
  Pow10Table() {
    for (int i = 0; i <= 120; ++i) t[i] = std::pow(10.0, i - 60);
  }
};

const double* pow10_table() {
  // C++11 magic static: thread-safe one-time init (parse threads race here
  // on the very first multi-threaded chunk)
  static const Pow10Table table;
  return table.t + 60;  // index by exponent directly
}

// fast float parser: [-+]?digits[.digits][(e|E)[-+]digits]; NaN on garbage.
// Returns value, advances *p to the first unconsumed char.
//
// Digits accumulate into an int64 mantissa (int multiply chain — roughly
// half the latency of the naive double val*10+d chain, which is THE hot
// serial dependency at 80M cells/chunk) and recombine with one table-lookup
// multiply. 18 significant digits are kept — beyond float32's 24-bit
// mantissa by a comfortable margin.
inline float parse_float(const char* p, const char* end, const char** out) {
  const char* s = p;
  while (s < end && (*s == ' ' || *s == '\t')) ++s;
  bool neg = false;
  if (s < end && (*s == '-' || *s == '+')) { neg = (*s == '-'); ++s; }
  // literal inf/nan (the writer emits them; real CSVs contain them too)
  if (s < end && (*s == 'i' || *s == 'I')) {
    if (end - s >= 3 && (s[1] == 'n' || s[1] == 'N')
        && (s[2] == 'f' || s[2] == 'F')) {
      *out = end;
      float v = std::numeric_limits<float>::infinity();
      return neg ? -v : v;
    }
  }
  uint64_t mant = 0;
  int exp10 = 0;
  int ndig = 0;  // significant digits — leading zeros are skipped below so
  bool any = false;  // they never burn the 18-digit mantissa budget
  while (s < end && *s == '0') { any = true; ++s; }
  while (s < end && *s >= '0' && *s <= '9') {
    if (ndig < 18) { mant = mant * 10 + (uint64_t)(*s - '0'); ++ndig; }
    else ++exp10;  // overflow digits only shift the magnitude
    any = true;
    ++s;
  }
  if (s < end && *s == '.') {
    ++s;
    if (mant == 0) {  // '0.000123': zeros shift the exponent, not the cap
      while (s < end && *s == '0') { any = true; --exp10; ++s; }
    }
    while (s < end && *s >= '0' && *s <= '9') {
      if (ndig < 18) { mant = mant * 10 + (uint64_t)(*s - '0'); ++ndig; --exp10; }
      any = true;
      ++s;
    }
  }
  if (any && s < end && (*s == 'e' || *s == 'E')) {
    const char* es = s + 1;
    bool eneg = false;
    if (es < end && (*es == '-' || *es == '+')) { eneg = (*es == '-'); ++es; }
    int ev = 0;
    bool eany = false;
    while (es < end && *es >= '0' && *es <= '9') {
      ev = ev * 10 + (*es - '0');
      eany = true;
      ++es;
    }
    if (eany) {
      exp10 += eneg ? -ev : ev;
      s = es;
    }
  }
  *out = s;
  if (!any) return std::nanf("");
  double val;
  if (exp10 == 0) {
    val = (double)mant;
  } else if (exp10 >= -60 && exp10 <= 60) {
    val = (double)mant * pow10_table()[exp10];
  } else {
    val = (double)mant * std::pow(10.0, exp10);  // clamps to inf/0 in f32
  }
  return static_cast<float>(neg ? -val : val);
}

// crc32-hash one cell's content; quoted cells hash their unescaped interior
// ("" -> "). The unescape path copies into a small stack/local buffer only
// when an escape is actually present.
inline float hash_cell(const char* p, const char* cell_end, bool quoted) {
  uint32_t code;
  if (!quoted) {
    code = crc32_bytes(p, cell_end - p);
  } else {
    // p points INSIDE the quotes, cell_end at the closing quote
    const char* esc = nullptr;
    for (const char* q = p; q + 1 < cell_end; ++q)
      if (*q == '"' && q[1] == '"') { esc = q; break; }
    if (!esc) {
      code = crc32_bytes(p, cell_end - p);
    } else {
      std::string tmp;
      tmp.reserve(cell_end - p);
      for (const char* q = p; q < cell_end; ++q) {
        tmp.push_back(*q);
        if (*q == '"' && q + 1 < cell_end && q[1] == '"') ++q;
      }
      code = crc32_bytes(tmp.data(), tmp.size());
    }
  }
  return static_cast<float>(code & kStringCodeMask);
}

// ----------------------------------------------------- SWAR digit parsing
// The numeric fast path eats 8 bytes per 64-bit load instead of one digit
// per loop iteration: the serial `mant = mant*10 + d` chain is THE parse
// bottleneck at Criteo scale (40 cells/row, ~7 digits/cell), and the SWAR
// recombination below turns 8 of those dependent multiplies into 3.
// Requires 8 readable bytes past any cell start — fcsv_read_chunk appends
// an 8-byte NUL sentinel to the block buffer before parsing.

// Length of the leading run of ASCII digits among the 8 loaded bytes
// (first char in the LOW byte — little-endian load).
inline int digit_run(uint64_t w) {
  uint64_t t = w ^ 0x3030303030303030ULL;  // '0'..'9' -> 0x00..0x09
  // bytes > 9 (or with the top bit set) light bit 7; '.' ',' '\n' all do
  uint64_t nd = ((t + 0x7676767676767676ULL) | t) & 0x8080808080808080ULL;
  return nd ? (int)(__builtin_ctzll(nd) >> 3) : 8;
}

// Value of 8 ASCII digits, first digit in the low byte (lemire's
// parse_eight_digits: two pair-merges and one 32-bit recombination).
inline uint64_t parse8(uint64_t val) {
  const uint64_t mask = 0x000000FF000000FFULL;
  const uint64_t mul1 = 0x000F424000000064ULL;  // 100 + (1000000 << 32)
  const uint64_t mul2 = 0x0000271000000001ULL;  // 1 + (10000 << 32)
  val -= 0x3030303030303030ULL;
  val = (val * 2561) >> 8;
  return (((val & mask) * mul1) + (((val >> 16) & mask) * mul2)) >> 32;
}

// Value of the first k (1..7) digit bytes of w: shift them toward the high
// bytes and fill the vacated low bytes with ASCII zeros, so parse8 sees a
// zero-padded 8-digit number.
inline uint64_t parse_k(uint64_t w, int k) {
  int sh = (8 - k) << 3;  // 8..56
  w = (w << sh) | (0x3030303030303030ULL >> (64 - sh));
  return parse8(w);
}

constexpr uint64_t kPow10U[9] = {1ull, 10ull, 100ull, 1000ull, 10000ull,
                                 100000ull, 1000000ull, 10000000ull,
                                 100000000ull};

// Fused scan+parse of one unquoted numeric cell starting at *pp: consumes
// [-+]?digits[.digits] and requires the next byte to be the delimiter or
// the row end. On success stores the value, advances *pp to the cell end,
// returns true. Returns false (with *pp untouched) when the cell needs the
// careful parser: exponents, inf/nan, spaces, junk, or >18 digits.
inline bool parse_cell_swar(const char** pp, const char* rend, char delim,
                            float* out) {
  const char* s = *pp;
  if (s == rend || *s == delim) {  // empty cell (row-final or mid-row)
    *out = std::nanf("");
    return true;
  }
  bool neg = false;
  if (*s == '-' || *s == '+') { neg = (*s == '-'); ++s; }
  uint64_t mant = 0;
  int exp10 = 0;
  int ndig = 0;     // SIGNIFICANT digits only — leading zeros must not
  bool any = false; // burn the 18-digit budget ('0000000000000000123')
  while (s < rend && *s == '0') { ++s; any = true; }
  for (;;) {  // integer digits, 8 per load
    uint64_t w;
    std::memcpy(&w, s, 8);
    int k = digit_run(w);
    if (k == 0) break;
    if (ndig + k > 18) return false;  // huge cell -> careful path
    mant = mant * kPow10U[k] + (k == 8 ? parse8(w) : parse_k(w, k));
    ndig += k;
    s += k;
    if (k < 8) break;  // run ended inside this load
  }
  any = any || ndig;
  if (s < rend && *s == '.') {
    ++s;
    if (mant == 0) {  // '0.000123': zeros shift the exponent, not the cap
      while (s < rend && *s == '0') { ++s; --exp10; any = true; }
    }
    for (;;) {  // fraction digits
      uint64_t w;
      std::memcpy(&w, s, 8);
      int k = digit_run(w);
      if (k == 0) break;
      if (ndig + k > 18) return false;
      mant = mant * kPow10U[k] + (k == 8 ? parse8(w) : parse_k(w, k));
      ndig += k;
      exp10 -= k;
      s += k;
      if (k < 8) break;
    }
    any = any || ndig;
  }
  if (!any) return false;              // '-', '.', 'nan', 'inf', text
  if (s != rend && *s != delim) return false;  // exponent/junk/spaces
  if (exp10 < -60) return false;       // subnormal-zero tail -> careful path
  double val = (double)mant;
  if (exp10) val *= pow10_table()[exp10];  // exp10 in [-60, 0]
  *out = (float)(neg ? -val : val);
  *pp = s;
  return true;
}

// parse rows [r0, r1) given newline offsets; writes out[row*ncols + col].
void parse_rows(const char* buf, const std::vector<size_t>& starts,
                const std::vector<size_t>& ends, size_t r0, size_t r1,
                int ncols, char delim, const uint8_t* is_cat, float* out) {
  for (size_t r = r0; r < r1; ++r) {
    const char* p = buf + starts[r];
    const char* end = buf + ends[r];
    float* row = out + r * ncols;
    int c = 0;
    while (c < ncols) {
      const bool cat = is_cat[c];
      if (p < end && *p == '"') {
        // quoted cell: delimiters inside the quotes belong to the cell
        // ("" escapes a quote)
        const char* q = p + 1;
        const char* content = q;
        while (q < end) {
          if (*q == '"') {
            if (q + 1 < end && q[1] == '"') { q += 2; continue; }
            break;  // closing quote
          }
          ++q;
        }
        if (cat) {
          row[c] = hash_cell(content, q, /*quoted=*/true);
        } else {
          const char* next;
          row[c] = parse_float(content, q, &next);
        }
        p = (q < end) ? q + 1 : q;  // past closing quote
        // skip to the delimiter
        while (p < end && *p != delim) ++p;
      } else if (!cat && parse_cell_swar(&p, end, delim, &row[c])) {
        // fused scan+parse consumed the cell and left p at its end
      } else {
        // categorical, or a numeric cell the SWAR path rejected
        // (exponent, inf/nan, text, spaces, >18 digits)
        const char* cell_end = static_cast<const char*>(
            memchr(p, delim, end - p));
        if (!cell_end) cell_end = end;
        if (cat) {
          row[c] = hash_cell(p, cell_end, /*quoted=*/false);
        } else {
          const char* next;
          row[c] = parse_float(p, cell_end, &next);
        }
        p = cell_end;
      }
      if (p < end) ++p;  // eat delimiter
      ++c;
      if (p >= end) break;
    }
    for (; c < ncols; ++c)
      row[c] = is_cat[c] ? hash_cell(nullptr, nullptr, false) : std::nanf("");
  }
}

}  // namespace

extern "C" {

void* fcsv_open(const char* path, char delim, int header) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto* h = new CsvHandle();
  h->f = f;
  h->delim = delim;
  // read the first line for the schema (names or column count)
  std::string line;
  int ch;
  while ((ch = std::fgetc(f)) != EOF && ch != '\n') line.push_back((char)ch);
  if (!line.empty() && line.back() == '\r') line.pop_back();
  // split the header on delimiters OUTSIDE quotes (RFC-4180: a quoted name
  // may contain the delimiter; "" escapes a quote)
  std::vector<std::string> fields(1);
  bool in_quotes = false;
  for (size_t i = 0; i < line.size(); ++i) {
    char c = line[i];
    if (c == '"') {
      if (in_quotes && i + 1 < line.size() && line[i + 1] == '"') {
        fields.back().push_back('"');
        fields.back().push_back('"');
        ++i;
      } else {
        in_quotes = !in_quotes;
        fields.back().push_back('"');
      }
    } else if (c == delim && !in_quotes) {
      fields.emplace_back();
    } else {
      fields.back().push_back(c);
    }
  }
  int ncols = (int)fields.size();
  h->ncols = ncols;
  h->is_cat.assign(ncols, 0);
  for (int j = 0; j < ncols; ++j) {
    h->colnames.push_back(header ? fields[j] : ("c" + std::to_string(j)));
  }
  if (!header) {
    // first line was data — replay it through the carry buffer
    h->carry.assign(line.begin(), line.end());
    h->carry.push_back('\n');
  }
  h->est_row_bytes = line.size() + 2;
  return h;
}

int fcsv_ncols(void* hv) { return static_cast<CsvHandle*>(hv)->ncols; }

const char* fcsv_colname(void* hv, int j) {
  auto* h = static_cast<CsvHandle*>(hv);
  if (j < 0 || j >= h->ncols) return "";
  return h->colnames[j].c_str();
}

// Mark column j categorical (cells crc32&0xFFFFFF-hashed instead of
// float-parsed). Returns 0 on success, -1 on bad index.
int fcsv_set_categorical(void* hv, int j, int on) {
  auto* h = static_cast<CsvHandle*>(hv);
  if (j < 0 || j >= h->ncols) return -1;
  h->is_cat[j] = on ? 1 : 0;
  return 0;
}

// Parse up to max_rows rows into out (row-major f32 [max_rows, ncols]).
// Returns rows produced; 0 => EOF. nthreads <= 0 => hardware concurrency.
long fcsv_read_chunk(void* hv, float* out, long max_rows, int nthreads) {
  auto* h = static_cast<CsvHandle*>(hv);
  if (max_rows <= 0) return 0;
  const int ncols = h->ncols;
  // move the carry to the front of the REUSED block buffer; capacity is
  // reserved once from the bytes/row estimate so steady-state chunks do
  // zero reallocation (a growing vector re-copies everything it holds on
  // every 4 MB top-up — quadratic and measurable at 1-core Criteo scale)
  std::vector<char>& buf = h->buf;
  buf.clear();
  size_t reserve_hint = h->est_row_bytes * (size_t)max_rows + (8u << 20);
  if (buf.capacity() < reserve_hint) buf.reserve(reserve_hint);
  buf.insert(buf.end(), h->carry.begin(), h->carry.end());
  h->carry.clear();
  std::vector<size_t>& starts = h->starts;
  std::vector<size_t>& ends = h->ends;
  starts.clear();
  ends.clear();
  starts.reserve(max_rows);
  ends.reserve(max_rows);
  size_t scan_from = 0;
  long nrows = 0;
  while (nrows < max_rows) {
    // find line breaks in what we have
    while (nrows < max_rows) {
      const char* base = buf.data();
      const char* nl = static_cast<const char*>(
          memchr(base + scan_from, '\n', buf.size() - scan_from));
      if (!nl) break;
      size_t line_end = nl - base;
      size_t line_start = scan_from;
      scan_from = line_end + 1;
      if (line_end > line_start && base[line_end - 1] == '\r') --line_end;
      if (line_end > line_start) {  // skip blank lines
        starts.push_back(line_start);
        ends.push_back(line_end);
        ++nrows;
      }
    }
    if (nrows >= max_rows || h->eof) break;
    // top up the buffer
    size_t old = buf.size();
    size_t want = 4u << 20;  // 4 MB reads
    buf.resize(old + want);
    size_t got = std::fread(buf.data() + old, 1, want, h->f);
    buf.resize(old + got);
    if (got == 0) {
      h->eof = true;
      // trailing line without newline
      if (scan_from < buf.size()) {
        size_t line_end = buf.size();
        if (line_end > scan_from && buf[line_end - 1] == '\r') --line_end;
        if (line_end > scan_from && nrows < max_rows) {
          starts.push_back(scan_from);
          ends.push_back(line_end);
          scan_from = buf.size();
          ++nrows;
        }
      }
      break;
    }
  }
  // stash the tail (unconsumed bytes) for the next chunk
  if (scan_from < buf.size()) {
    h->carry.assign(buf.begin() + scan_from, buf.end());
  }
  if (nrows == 0) return 0;
  if (h->rows_read == 0 && nrows > 16) {
    // adapt the reserve hint to the observed data density
    h->est_row_bytes = (ends[nrows - 1] - starts[0]) / (size_t)nrows + 2;
  }
  // 8-byte NUL sentinel: parse_cell_swar loads 8 bytes from any position
  // inside a row extent, so the final row's tail needs readable slack.
  // Appended AFTER the carry stash (the sentinel must not enter the carry)
  // and before threads capture buf.data().
  buf.insert(buf.end(), 8, '\0');
  int T = nthreads > 0 ? nthreads
                       : (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  if ((long)T > nrows) T = (int)nrows;
  if (T == 1) {
    parse_rows(buf.data(), starts, ends, 0, nrows, ncols, h->delim,
               h->is_cat.data(), out);
  } else {
    std::vector<std::thread> threads;
    size_t per = (nrows + T - 1) / T;
    for (int t = 0; t < T; ++t) {
      size_t r0 = t * per;
      size_t r1 = std::min<size_t>(r0 + per, nrows);
      if (r0 >= r1) break;
      threads.emplace_back(parse_rows, buf.data(), std::cref(starts),
                           std::cref(ends), r0, r1, ncols, h->delim,
                           h->is_cat.data(), out);
    }
    for (auto& th : threads) th.join();
  }
  h->rows_read += nrows;
  return nrows;
}

void fcsv_close(void* hv) {
  auto* h = static_cast<CsvHandle*>(hv);
  if (h->f) std::fclose(h->f);
  delete h;
}

// Write a row-major f32 [nrows, ncols] matrix as CSV (the df.write.csv
// role). header: '\n'-joined column names, or NULL/empty for none.
// Shortest-round-trip float formatting via C++17 to_chars — an order of
// magnitude past stdio %g paths. Returns 0 on success, -1 on IO error.
int fcsv_write(const char* path, const float* data, long nrows, int ncols,
               const char* header, char delim) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::vector<char> buf;
  buf.reserve(1u << 22);
  if (header && header[0]) {
    for (const char* p = header; *p; ++p)
      buf.push_back(*p == '\n' ? delim : *p);
    buf.push_back('\n');
    // the last name must not end with a delimiter artifact: header is
    // passed '\n'-joined, so the loop above already placed delimiters
  }
  char tmp[48];
  for (long r = 0; r < nrows; ++r) {
    const float* row = data + (size_t)r * ncols;
    for (int c = 0; c < ncols; ++c) {
      if (c) buf.push_back(delim);
      float v = row[c];
      if (std::isnan(v)) {
        // empty cell: the reader's parse_float returns NaN for it
      } else {
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
        // shortest round-trip float repr (needs the FULL to_chars, i.e.
        // floating-point support — libstdc++ 10 ships only the integral
        // overloads and leaves __cpp_lib_to_chars undefined)
        auto res = std::to_chars(tmp, tmp + sizeof tmp, v);
        buf.insert(buf.end(), tmp, res.ptr);
#else
        // %.9g is round-trip-exact for float32 (9 significant digits)
        int len = std::snprintf(tmp, sizeof tmp, "%.9g", (double)v);
        buf.insert(buf.end(), tmp, tmp + len);
#endif
      }
    }
    buf.push_back('\n');
    if (buf.size() > (3u << 22)) {
      if (std::fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
        std::fclose(f);
        return -1;
      }
      buf.clear();
    }
  }
  size_t ok = std::fwrite(buf.data(), 1, buf.size(), f);
  bool fail = ok != buf.size();
  if (std::fclose(f) != 0) fail = true;
  return fail ? -1 : 0;
}

}  // extern "C"
