// Criteo TSV -> Raw binary converter (CLI), the port's copy of
// native/criteo_convert.cpp, built and run by tools/criteo_to_raw.py.
//
// Counterpart of the reference's DLRM raw-conversion tool
// (reference: tools/dlrm_script/ — CUDA-accelerated Criteo TSV to raw
// binary for the RawAsync reader). This is a multithreaded host C++
// implementation: chunks of lines are parsed in parallel and written in
// order as fixed-stride int32 rows
//   [label][13 int dense][26 int32 categorical]
// matching the documented MLPerf raw layout
// (docs/source/api/python_interface.md:362-383); dense stays integral —
// readers apply log(x+1) (split_batch.cu semantics).
//
// Categorical hex ids are hashed with `value % vocab_cap`. With --remap,
// a first pass counts per-column key frequencies and ids are renumbered by
// descending frequency (id 0 = most frequent), enabling the
// frequent/infrequent hot/cold embedding split (HybridEmbedding lineage).
//
// Usage:
//   criteo_convert --input day.tsv --output day.bin \
//       [--vocab_cap 40000000] [--threads 8] [--remap] [--max_rows N]
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <iostream>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kDense = 13;
constexpr int kCats = 26;
constexpr int kCols = 1 + kDense + kCats;

struct Args {
  std::string input, output;
  int64_t vocab_cap = 40000000;
  int threads = 8;
  bool remap = false;
  int64_t max_rows = 0;
};

// Parse one TSV line into int32 row values. Missing dense -> 0; missing
// categorical -> 0. Hex categoricals parsed base-16.
void parse_line(const char* s, const char* end, int64_t vocab_cap,
                int32_t* out) {
  int col = 0;
  const char* p = s;
  while (col < kCols) {
    const char* tab = p;
    while (tab < end && *tab != '\t') ++tab;
    if (col == 0 || col <= kDense) {
      // label / dense: decimal int (may be negative or empty)
      int64_t v = 0;
      bool neg = false;
      const char* q = p;
      if (q < tab && *q == '-') { neg = true; ++q; }
      for (; q < tab; ++q)
        if (*q >= '0' && *q <= '9') v = v * 10 + (*q - '0');
      out[col] = static_cast<int32_t>(neg ? -v : v);
    } else {
      // categorical: hex string
      uint64_t v = 0;
      for (const char* q = p; q < tab; ++q) {
        char c = *q;
        uint64_t d;
        if (c >= '0' && c <= '9') d = c - '0';
        else if (c >= 'a' && c <= 'f') d = 10 + (c - 'a');
        else if (c >= 'A' && c <= 'F') d = 10 + (c - 'A');
        else continue;
        v = (v << 4) | d;
      }
      out[col] = static_cast<int32_t>(v % static_cast<uint64_t>(vocab_cap));
    }
    ++col;
    p = (tab < end) ? tab + 1 : end;
  }
}

struct Chunk {
  std::vector<char> text;          // raw lines
  std::vector<size_t> line_off;    // offsets of line starts (+ end)
  std::vector<int32_t> rows;       // parsed output
};

// Read the input in large chunks aligned to line boundaries.
class ChunkReader {
 public:
  ChunkReader(const std::string& path, size_t chunk_bytes)
      : in_(path, std::ios::binary), chunk_bytes_(chunk_bytes) {}
  bool ok() const { return in_.good(); }
  bool next(std::vector<char>* out) {
    if (!in_ || in_.eof()) return carry_.empty() ? false : flush(out);
    out->resize(carry_.size() + chunk_bytes_);
    std::memcpy(out->data(), carry_.data(), carry_.size());
    in_.read(out->data() + carry_.size(), chunk_bytes_);
    size_t got = carry_.size() + static_cast<size_t>(in_.gcount());
    out->resize(got);
    carry_.clear();
    if (got == 0) return false;
    if (!in_.eof()) {
      // push the trailing partial line into carry
      size_t last_nl = got;
      while (last_nl > 0 && (*out)[last_nl - 1] != '\n') --last_nl;
      if (last_nl == 0) {  // single huge line; keep everything
        return true;
      }
      carry_.assign(out->begin() + last_nl, out->end());
      out->resize(last_nl);
    }
    return true;
  }

 private:
  bool flush(std::vector<char>* out) {
    *out = carry_;
    carry_.clear();
    return !out->empty();
  }
  std::ifstream in_;
  size_t chunk_bytes_;
  std::vector<char> carry_;
};

void split_lines(const std::vector<char>& text,
                 std::vector<size_t>* line_off) {
  line_off->clear();
  line_off->push_back(0);
  for (size_t i = 0; i < text.size(); ++i)
    if (text[i] == '\n') line_off->push_back(i + 1);
  if (line_off->back() != text.size()) line_off->push_back(text.size());
}

// Parse one chunk's lines into rows with `threads` workers.
void parse_chunk(const std::vector<char>& text,
                 const std::vector<size_t>& line_off, int threads,
                 int64_t vocab_cap, std::vector<int32_t>* rows) {
  size_t n = line_off.size() - 1;
  rows->assign(n * kCols, 0);
  std::atomic<size_t> next(0);
  auto work = [&]() {
    for (;;) {
      size_t i = next.fetch_add(256);
      if (i >= n) return;
      size_t hi = std::min(i + 256, n);
      for (; i < hi; ++i) {
        const char* s = text.data() + line_off[i];
        const char* e = text.data() + line_off[i + 1];
        while (e > s && (e[-1] == '\n' || e[-1] == '\r')) --e;
        if (e > s) parse_line(s, e, vocab_cap, rows->data() + i * kCols);
      }
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < threads; ++t) ts.emplace_back(work);
  for (auto& t : ts) t.join();
}

int run(const Args& a) {
  const size_t kChunk = 64u << 20;
  // optional remap pass 1: per-column frequency counts
  std::vector<std::unordered_map<int32_t, int64_t>> counts;
  if (a.remap) {
    counts.resize(kCats);
    ChunkReader cr(a.input, kChunk);
    if (!cr.ok()) { std::cerr << "cannot open " << a.input << "\n"; return 2; }
    std::vector<char> text;
    std::vector<size_t> off;
    std::vector<int32_t> rows;
    int64_t seen = 0;
    while (cr.next(&text)) {
      split_lines(text, &off);
      parse_chunk(text, off, a.threads, a.vocab_cap, &rows);
      size_t n = off.size() - 1;
      if (a.max_rows && seen + static_cast<int64_t>(n) > a.max_rows)
        n = static_cast<size_t>(a.max_rows - seen);
      // count with kCats workers (one column per task; cheap + lock-free)
      std::atomic<int> next_col(0);
      auto cwork = [&]() {
        for (;;) {
          int c = next_col.fetch_add(1);
          if (c >= kCats) return;
          auto& m = counts[c];
          for (size_t i = 0; i < n; ++i)
            ++m[rows[i * kCols + 1 + kDense + c]];
        }
      };
      std::vector<std::thread> ts;
      for (int t = 0; t < std::min(a.threads, kCats); ++t)
        ts.emplace_back(cwork);
      for (auto& t : ts) t.join();
      seen += static_cast<int64_t>(n);
      if (a.max_rows && seen >= a.max_rows) break;
    }
  }
  // build remap tables (id by descending frequency; ties by key for
  // determinism)
  std::vector<std::unordered_map<int32_t, int32_t>> remap(a.remap ? kCats : 0);
  if (a.remap) {
    for (int c = 0; c < kCats; ++c) {
      std::vector<std::pair<int64_t, int32_t>> order;
      order.reserve(counts[c].size());
      for (auto& kv : counts[c]) order.push_back({-kv.second, kv.first});
      std::sort(order.begin(), order.end());
      auto& m = remap[c];
      m.reserve(order.size());
      for (size_t i = 0; i < order.size(); ++i)
        m[order[i].second] = static_cast<int32_t>(i);
      counts[c].clear();
    }
  }
  // pass 2 (or only pass): convert + write
  ChunkReader cr(a.input, kChunk);
  if (!cr.ok()) { std::cerr << "cannot open " << a.input << "\n"; return 2; }
  std::ofstream out(a.output, std::ios::binary);
  if (!out) { std::cerr << "cannot write " << a.output << "\n"; return 2; }
  std::vector<char> text;
  std::vector<size_t> off;
  std::vector<int32_t> rows;
  int64_t written = 0;
  while (cr.next(&text)) {
    split_lines(text, &off);
    parse_chunk(text, off, a.threads, a.vocab_cap, &rows);
    size_t n = off.size() - 1;
    if (a.max_rows && written + static_cast<int64_t>(n) > a.max_rows)
      n = static_cast<size_t>(a.max_rows - written);
    if (a.remap) {
      std::atomic<size_t> next(0);
      auto rwork = [&]() {
        for (;;) {
          size_t i = next.fetch_add(256);
          if (i >= n) return;
          size_t hi = std::min(i + 256, n);
          for (; i < hi; ++i)
            for (int c = 0; c < kCats; ++c) {
              int32_t& v = rows[i * kCols + 1 + kDense + c];
              v = remap[c].at(v);
            }
        }
      };
      std::vector<std::thread> ts;
      for (int t = 0; t < a.threads; ++t) ts.emplace_back(rwork);
      for (auto& t : ts) t.join();
    }
    out.write(reinterpret_cast<const char*>(rows.data()),
              static_cast<std::streamsize>(n * kCols * sizeof(int32_t)));
    written += static_cast<int64_t>(n);
    if (a.max_rows && written >= a.max_rows) break;
  }
  std::cerr << "criteo_convert: wrote " << written << " rows to " << a.output
            << (a.remap ? " (frequency-remapped)" : "") << "\n";
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  Args a;
  for (int i = 1; i < argc; ++i) {
    std::string f = argv[i];
    auto next = [&]() -> std::string {
      return (i + 1 < argc) ? argv[++i] : "";
    };
    if (f == "--input") a.input = next();
    else if (f == "--output") a.output = next();
    else if (f == "--vocab_cap") a.vocab_cap = std::stoll(next());
    else if (f == "--threads") a.threads = std::stoi(next());
    else if (f == "--max_rows") a.max_rows = std::stoll(next());
    else if (f == "--remap") a.remap = true;
    else { std::cerr << "unknown flag " << f << "\n"; return 2; }
  }
  if (a.input.empty() || a.output.empty()) {
    std::cerr << "usage: criteo_convert --input day.tsv --output day.bin "
                 "[--vocab_cap N] [--threads N] [--remap] [--max_rows N]\n";
    return 2;
  }
  return run(a);
}
