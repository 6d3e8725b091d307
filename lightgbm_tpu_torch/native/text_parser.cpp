// Native text-data parser: the data-loader hot path.
//
// The port's own copy of lightgbm_tpu's native parser, the equivalent of
// the reference's C++ parsing pipeline (reference: src/io/parser.cpp
// CSVParser/TSVParser/LibSVMParser with Parser::CreateParser format
// auto-detection, and the chunked reading of src/io/dataset_loader.cpp
// LoadTextDataToMemory). Design differences from the reference: we parse
// straight into a dense row-major double matrix (the Dataset consumes a
// dense [N, F] block to bin on the device), and we
// parallelize by splitting the mmap'd file into per-thread line-aligned
// chunks instead of a producer/consumer pipeline reader.
//
// Exposed as a tiny C ABI for ctypes (no pybind11 in this image).
//
// Build (native/__init__.py does it on first use):
//   g++ -O3 -std=c++17 -shared -fPIC -pthread text_parser.cpp \
//       -o lightgbm_tpu_torch/_build/libtextparser_<hash>.so

#include <cctype>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

enum Format { FMT_CSV = 0, FMT_TSV = 1, FMT_LIBSVM = 2 };

struct ParseResult {
  std::vector<double> data;  // row-major rows x cols
  int64_t rows = 0;
  int64_t cols = 0;
  int format = FMT_CSV;
  std::string error;
};

// fast double parse wrapper; strtod handles inf/nan/scientific
inline double ParseDouble(const char* p, char** end) {
  return std::strtod(p, end);
}

inline bool IsBlankLine(const char* p, const char* e) {
  while (p < e) {
    if (!std::isspace(static_cast<unsigned char>(*p))) return false;
    ++p;
  }
  return true;
}

// format auto-detection from a sample line
// (reference: parser.cpp DetermineDataFormat-equivalent sampling logic)
int DetectFormat(const char* line, const char* end) {
  bool has_colon = false, has_tab = false, has_comma = false;
  for (const char* p = line; p < end; ++p) {
    if (*p == ':') has_colon = true;
    else if (*p == '\t') has_tab = true;
    else if (*p == ',') has_comma = true;
  }
  if (has_colon) return FMT_LIBSVM;
  if (has_tab) return FMT_TSV;
  if (has_comma) return FMT_CSV;
  return FMT_TSV;  // whitespace-separated parses via the TSV tokenizer
}

// split the buffer into line ranges [begin, end) excluding the newline
void SplitLines(const char* buf, size_t len,
                std::vector<std::pair<const char*, const char*>>* lines) {
  const char* p = buf;
  const char* file_end = buf + len;
  while (p < file_end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', file_end - p));
    const char* e = nl ? nl : file_end;
    const char* trimmed = e;
    while (trimmed > p && (trimmed[-1] == '\r')) --trimmed;
    if (!IsBlankLine(p, trimmed)) lines->emplace_back(p, trimmed);
    p = nl ? nl + 1 : file_end;
  }
}

// number of delimited columns in one CSV/TSV line
int64_t CountColumns(const char* p, const char* e, char delim) {
  int64_t n = 1;
  for (; p < e; ++p)
    if (*p == delim) ++n;
  return n;
}

void ParseDelimitedRange(const std::vector<std::pair<const char*, const char*>>& lines,
                         size_t lo, size_t hi, char delim, int64_t cols,
                         double* out) {
  for (size_t i = lo; i < hi; ++i) {
    const char* p = lines[i].first;
    const char* e = lines[i].second;
    double* row = out + static_cast<int64_t>(i) * cols;
    int64_t c = 0;
    while (p <= e && c < cols) {
      if (p == e || *p == delim) {
        row[c++] = std::nan("");  // empty field -> NaN (reference: common.h Atof "")
        if (p == e) break;
        ++p;
        continue;
      }
      char* endp = nullptr;
      double v = ParseDouble(p, &endp);
      if (endp == p) {  // unparsable token (e.g. "na") -> NaN, skip token
        v = std::nan("");
        while (p < e && *p != delim) ++p;
      } else {
        p = endp;
        while (p < e && *p != delim) ++p;  // tolerate trailing spaces
      }
      row[c++] = v;
      if (p < e && *p == delim) ++p;
      else if (p >= e) break;
    }
    for (; c < cols; ++c) row[c] = std::nan("");
  }
}

// whitespace-separated variant (the reference's TSV parser also accepts
// single spaces; example files use tabs)
void ParseWhitespaceRange(const std::vector<std::pair<const char*, const char*>>& lines,
                          size_t lo, size_t hi, int64_t cols, double* out) {
  for (size_t i = lo; i < hi; ++i) {
    const char* p = lines[i].first;
    const char* e = lines[i].second;
    double* row = out + static_cast<int64_t>(i) * cols;
    int64_t c = 0;
    while (p < e && c < cols) {
      while (p < e && std::isspace(static_cast<unsigned char>(*p))) ++p;
      if (p >= e) break;
      char* endp = nullptr;
      double v = ParseDouble(p, &endp);
      if (endp == p) {
        v = std::nan("");
        while (p < e && !std::isspace(static_cast<unsigned char>(*p))) ++p;
      } else {
        p = endp;
      }
      row[c++] = v;
    }
    for (; c < cols; ++c) row[c] = std::nan("");
  }
}

// LibSVM: "label idx:val idx:val ..." with idx >= 0; absent entries are 0
// (reference: parser.cpp LibSVMParser; zeros match the reference's sparse
// semantics where missing pairs are zero, not NaN)
void ParseLibSVMRange(const std::vector<std::pair<const char*, const char*>>& lines,
                      size_t lo, size_t hi, int64_t cols, double* out) {
  for (size_t i = lo; i < hi; ++i) {
    const char* p = lines[i].first;
    const char* e = lines[i].second;
    double* row = out + static_cast<int64_t>(i) * cols;
    std::memset(row, 0, sizeof(double) * cols);
    char* endp = nullptr;
    row[0] = ParseDouble(p, &endp);  // label
    p = endp;
    while (p < e) {
      while (p < e && std::isspace(static_cast<unsigned char>(*p))) ++p;
      if (p >= e) break;
      long idx = std::strtol(p, &endp, 10);
      if (endp == p || *endp != ':') {  // qid:... or junk -> skip token
        while (p < e && !std::isspace(static_cast<unsigned char>(*p))) ++p;
        continue;
      }
      p = endp + 1;
      double v = ParseDouble(p, &endp);
      p = endp;
      if (idx >= 0 && idx + 1 < cols) row[idx + 1] = v;
    }
  }
}

int64_t MaxLibSVMIndex(const std::vector<std::pair<const char*, const char*>>& lines,
                       size_t lo, size_t hi) {
  int64_t mx = -1;
  for (size_t i = lo; i < hi; ++i) {
    const char* p = lines[i].first;
    const char* e = lines[i].second;
    while (p < e) {
      const char* colon = static_cast<const char*>(memchr(p, ':', e - p));
      if (!colon) break;
      const char* q = colon;
      while (q > p && std::isdigit(static_cast<unsigned char>(q[-1]))) --q;
      if (q < colon) {
        long idx = std::strtol(q, nullptr, 10);
        if (idx > mx) mx = idx;
      }
      p = colon + 1;
    }
  }
  return mx;
}

ParseResult* ParseBuffer(const char* buf, size_t len, int has_header,
                         int num_threads) {
  auto* res = new ParseResult();
  std::vector<std::pair<const char*, const char*>> lines;
  SplitLines(buf, len, &lines);
  if (has_header && !lines.empty()) lines.erase(lines.begin());
  if (lines.empty()) {
    res->error = "no data rows";
    return res;
  }
  res->format = DetectFormat(lines[0].first, lines[0].second);
  size_t n = lines.size();
  if (num_threads <= 0)
    num_threads = static_cast<int>(std::thread::hardware_concurrency());
  num_threads = std::max(1, std::min<int>(num_threads, 32));
  size_t chunk = (n + num_threads - 1) / num_threads;

  // column count
  int64_t cols;
  if (res->format == FMT_LIBSVM) {
    std::vector<int64_t> mx(num_threads, -1);
    std::vector<std::thread> th;
    for (int t = 0; t < num_threads; ++t) {
      size_t lo = t * chunk, hi = std::min(n, lo + chunk);
      if (lo >= hi) continue;
      th.emplace_back([&, t, lo, hi] { mx[t] = MaxLibSVMIndex(lines, lo, hi); });
    }
    for (auto& x : th) x.join();
    int64_t m = -1;
    for (auto v : mx) m = std::max(m, v);
    cols = m + 2;  // label + features 0..m
  } else {
    char delim = res->format == FMT_CSV ? ',' : '\t';
    bool has_delim =
        memchr(lines[0].first, delim, lines[0].second - lines[0].first) != nullptr;
    if (res->format == FMT_TSV && !has_delim) res->format = 3;  // whitespace
    if (res->format == 3) {
      // count whitespace-separated tokens on the first line
      const char* p = lines[0].first;
      const char* e = lines[0].second;
      cols = 0;
      while (p < e) {
        while (p < e && std::isspace(static_cast<unsigned char>(*p))) ++p;
        if (p >= e) break;
        ++cols;
        while (p < e && !std::isspace(static_cast<unsigned char>(*p))) ++p;
      }
    } else {
      cols = CountColumns(lines[0].first, lines[0].second, delim);
    }
  }
  res->rows = static_cast<int64_t>(n);
  res->cols = cols;
  res->data.resize(res->rows * cols);

  std::vector<std::thread> th;
  for (int t = 0; t < num_threads; ++t) {
    size_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) continue;
    th.emplace_back([&, lo, hi] {
      if (res->format == FMT_LIBSVM)
        ParseLibSVMRange(lines, lo, hi, cols, res->data.data());
      else if (res->format == 3)
        ParseWhitespaceRange(lines, lo, hi, cols, res->data.data());
      else
        ParseDelimitedRange(lines, lo, hi,
                            res->format == FMT_CSV ? ',' : '\t', cols,
                            res->data.data());
    });
  }
  for (auto& x : th) x.join();
  if (res->format == 3) res->format = FMT_TSV;
  return res;
}

}  // namespace

extern "C" {

// Parse a text file. Returns an opaque handle (nullptr on IO error).
void* ltp_parse_file(const char* path, int has_header, int num_threads) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  // +1 NUL terminator: strtod on the final token of a file without a
  // trailing newline must not read past the buffer
  std::vector<char> buf(static_cast<size_t>(size) + 1, '\0');
  size_t got = size > 0 ? std::fread(buf.data(), 1, size, f) : 0;
  std::fclose(f);
  return ParseBuffer(buf.data(), got, has_header, num_threads);
}

void* ltp_parse_buffer(const char* buf, int64_t len, int has_header,
                       int num_threads) {
  // copy into a NUL-terminated buffer: the caller's memory need not be
  // terminated and strtod can scan one past the last token
  std::vector<char> owned(buf, buf + static_cast<size_t>(len));
  owned.push_back('\0');
  return ParseBuffer(owned.data(), static_cast<size_t>(len), has_header,
                     num_threads);
}

int64_t ltp_rows(void* h) { return static_cast<ParseResult*>(h)->rows; }
int64_t ltp_cols(void* h) { return static_cast<ParseResult*>(h)->cols; }
int ltp_format(void* h) { return static_cast<ParseResult*>(h)->format; }
const char* ltp_error(void* h) {
  return static_cast<ParseResult*>(h)->error.c_str();
}
const double* ltp_data(void* h) {
  return static_cast<ParseResult*>(h)->data.data();
}
void ltp_free(void* h) { delete static_cast<ParseResult*>(h); }

}  // extern "C"
