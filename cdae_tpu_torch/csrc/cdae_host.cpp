// Host runtime of cdae_tpu_torch: multithreaded text -> COO loading with
// string -> id vocab building, the counting-sort CSR build, and a dynamic
// work-queue parallel_for. Plain host C++ (no CUDA), a copy of the JAX
// package's csrc/cdae_host.cpp with the same C ABI, so both packages load
// the same files into the same arrays and vocabularies.
//
// Counterpart of the reference's C++ base layer: FileLineReader streaming
// (src/base/io/file_line_reader.hpp:11-31), FeatureGroupInfo::get_index
// vocab growth (src/base/instance-inl.hpp:22-37) and the hashtable views
// (src/base/data-inl.hpp:318-429), as flat-array producers. Chunked parsing
// over threads replaces the reference's single-threaded line loop.
//
// Exposed as a plain C ABI for ctypes. cdae_tpu_torch/_native builds it
// with g++ on first use into build/cdae_tpu_torch/.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Dataset {
  std::vector<int32_t> users, items;
  std::vector<float> ratings;
  std::vector<std::string> user_tokens, item_tokens;
};

// format: 0 = whitespace "user item [rating]" with implicit rating 1
//         1 = movielens "user::item::rating[::ts]"
struct Triple {
  std::string_view u, i, r;
};

inline bool parse_line(std::string_view line, int format, Triple* out) {
  if (format == 1) {
    size_t a = line.find("::");
    if (a == std::string_view::npos) return false;
    size_t b = line.find("::", a + 2);
    if (b == std::string_view::npos) return false;
    size_t c = line.find("::", b + 2);
    out->u = line.substr(0, a);
    out->i = line.substr(a + 2, b - a - 2);
    out->r = (c == std::string_view::npos) ? line.substr(b + 2)
                                           : line.substr(b + 2, c - b - 2);
    return !out->u.empty() && !out->i.empty() && !out->r.empty();
  }
  // whitespace format
  size_t p = 0, n = line.size();
  auto skip_ws = [&] { while (p < n && (line[p] == ' ' || line[p] == '\t')) ++p; };
  auto token = [&]() -> std::string_view {
    size_t s = p;
    while (p < n && line[p] != ' ' && line[p] != '\t') ++p;
    return line.substr(s, p - s);
  };
  skip_ws();
  out->u = token();
  skip_ws();
  out->i = token();
  skip_ws();
  out->r = token();  // may be empty -> implicit 1 (ref yelp.cpp:60-66)
  return !out->u.empty() && !out->i.empty();
}

struct ChunkResult {
  std::vector<std::string> u_tok, i_tok;  // tokens in first-seen order
  std::unordered_map<std::string, int32_t> u_map, i_map;
  std::vector<int32_t> u_local, i_local;  // per-row local ids
  std::vector<float> ratings;
};

void parse_chunk(const char* begin, const char* end, int format,
                 ChunkResult* res) {
  const char* p = begin;
  Triple t;
  while (p < end) {
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* line_end = nl ? nl : end;
    std::string_view line(p, static_cast<size_t>(line_end - p));
    if (!line.empty() && line.back() == '\r') line.remove_suffix(1);
    if (!line.empty() && parse_line(line, format, &t)) {
      auto intern = [](std::string_view sv,
                       std::unordered_map<std::string, int32_t>& map,
                       std::vector<std::string>& toks) -> int32_t {
        auto it = map.find(std::string(sv));
        if (it != map.end()) return it->second;
        int32_t id = static_cast<int32_t>(toks.size());
        toks.emplace_back(sv);
        map.emplace(toks.back(), id);
        return id;
      };
      res->u_local.push_back(intern(t.u, res->u_map, res->u_tok));
      res->i_local.push_back(intern(t.i, res->i_map, res->i_tok));
      // format 0 maps every line to label 1 like the reference app parser
      // (yelp.cpp:60-66); format 1 keeps the explicit rating
      float r = 1.0f;
      if (format == 1 && !t.r.empty())
        r = strtof(std::string(t.r).c_str(), nullptr);
      res->ratings.push_back(r);
    }
    p = nl ? nl + 1 : end;
  }
}

}  // namespace

extern "C" {

// ---- loader ---------------------------------------------------------------

void* cdae_loader_parse(const char* path, int format, int num_threads) {
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f) return nullptr;
  size_t size = static_cast<size_t>(f.tellg());
  f.seekg(0);
  std::vector<char> buf(size);
  if (size && !f.read(buf.data(), static_cast<std::streamsize>(size)))
    return nullptr;

  int nt = num_threads > 0
               ? num_threads
               : static_cast<int>(std::thread::hardware_concurrency());
  nt = std::max(1, std::min<int>(nt, 64));
  if (size < (1u << 20)) nt = 1;  // small files: no thread overhead

  // chunk boundaries aligned to newlines
  std::vector<const char*> bounds(static_cast<size_t>(nt) + 1);
  bounds[0] = buf.data();
  bounds[static_cast<size_t>(nt)] = buf.data() + size;
  for (int k = 1; k < nt; ++k) {
    const char* guess = buf.data() + size * static_cast<size_t>(k) / nt;
    const char* nl = static_cast<const char*>(
        memchr(guess, '\n', static_cast<size_t>(buf.data() + size - guess)));
    bounds[static_cast<size_t>(k)] = nl ? nl + 1 : buf.data() + size;
  }

  std::vector<ChunkResult> chunks(static_cast<size_t>(nt));
  std::vector<std::thread> threads;
  for (int k = 0; k < nt; ++k)
    threads.emplace_back(parse_chunk, bounds[static_cast<size_t>(k)],
                         bounds[static_cast<size_t>(k) + 1], format,
                         &chunks[static_cast<size_t>(k)]);
  for (auto& th : threads) th.join();

  // merge: global vocab in first-seen (chunk-ordered) order — matches the
  // reference's sequential get_index growth for a single-threaded read
  auto* ds = new Dataset();
  std::unordered_map<std::string, int32_t> u_map, i_map;
  size_t total = 0;
  for (auto& c : chunks) total += c.ratings.size();
  ds->users.reserve(total);
  ds->items.reserve(total);
  ds->ratings.reserve(total);
  for (auto& c : chunks) {
    std::vector<int32_t> u_remap(c.u_tok.size()), i_remap(c.i_tok.size());
    for (size_t j = 0; j < c.u_tok.size(); ++j) {
      auto it = u_map.find(c.u_tok[j]);
      if (it == u_map.end()) {
        int32_t id = static_cast<int32_t>(ds->user_tokens.size());
        ds->user_tokens.push_back(c.u_tok[j]);
        u_map.emplace(c.u_tok[j], id);
        u_remap[j] = id;
      } else {
        u_remap[j] = it->second;
      }
    }
    for (size_t j = 0; j < c.i_tok.size(); ++j) {
      auto it = i_map.find(c.i_tok[j]);
      if (it == i_map.end()) {
        int32_t id = static_cast<int32_t>(ds->item_tokens.size());
        ds->item_tokens.push_back(c.i_tok[j]);
        i_map.emplace(c.i_tok[j], id);
        i_remap[j] = id;
      } else {
        i_remap[j] = it->second;
      }
    }
    for (size_t r = 0; r < c.ratings.size(); ++r) {
      ds->users.push_back(u_remap[static_cast<size_t>(c.u_local[r])]);
      ds->items.push_back(i_remap[static_cast<size_t>(c.i_local[r])]);
      ds->ratings.push_back(c.ratings[r]);
    }
  }
  return ds;
}

int64_t cdae_loader_num_rows(void* h) {
  return static_cast<int64_t>(static_cast<Dataset*>(h)->users.size());
}
int64_t cdae_loader_num_users(void* h) {
  return static_cast<int64_t>(static_cast<Dataset*>(h)->user_tokens.size());
}
int64_t cdae_loader_num_items(void* h) {
  return static_cast<int64_t>(static_cast<Dataset*>(h)->item_tokens.size());
}

void cdae_loader_copy(void* h, int32_t* users, int32_t* items,
                      float* ratings) {
  auto* ds = static_cast<Dataset*>(h);
  memcpy(users, ds->users.data(), ds->users.size() * sizeof(int32_t));
  memcpy(items, ds->items.data(), ds->items.size() * sizeof(int32_t));
  memcpy(ratings, ds->ratings.data(), ds->ratings.size() * sizeof(float));
}

const char* cdae_loader_user_token(void* h, int64_t i) {
  return static_cast<Dataset*>(h)->user_tokens[static_cast<size_t>(i)].c_str();
}
const char* cdae_loader_item_token(void* h, int64_t i) {
  return static_cast<Dataset*>(h)->item_tokens[static_cast<size_t>(i)].c_str();
}

void cdae_loader_free(void* h) { delete static_cast<Dataset*>(h); }

// ---- CSR build ------------------------------------------------------------
// Counting-sort CSR: stable per-key bucketing (keys ascending), then an
// in-row sort by column id — the layout every model consumes
// (sorted ascending rows enable exact complement negative sampling).

void cdae_build_csr(const int32_t* keys, const int32_t* vals,
                    const float* ratings, int64_t n, int64_t num_keys,
                    int64_t* indptr /* num_keys+1 */,
                    int32_t* indices /* n */, float* values /* n */) {
  std::vector<int64_t> counts(static_cast<size_t>(num_keys) + 1, 0);
  for (int64_t r = 0; r < n; ++r) ++counts[static_cast<size_t>(keys[r]) + 1];
  for (int64_t k = 0; k < num_keys; ++k)
    counts[static_cast<size_t>(k) + 1] += counts[static_cast<size_t>(k)];
  memcpy(indptr, counts.data(),
         (static_cast<size_t>(num_keys) + 1) * sizeof(int64_t));
  std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
  std::vector<int64_t> order(static_cast<size_t>(n));
  for (int64_t r = 0; r < n; ++r)
    order[static_cast<size_t>(cursor[static_cast<size_t>(keys[r])]++)] = r;
  for (int64_t p = 0; p < n; ++p) {
    indices[p] = vals[order[static_cast<size_t>(p)]];
    values[p] = ratings[order[static_cast<size_t>(p)]];
  }
  // in-row sort by (column, original order) — parallel over key ranges
  int nt = std::max(1u, std::thread::hardware_concurrency());
  std::atomic<int64_t> next_key(0);
  auto worker = [&] {
    std::vector<std::pair<int32_t, float>> row;
    for (;;) {
      int64_t k = next_key.fetch_add(64);
      if (k >= num_keys) return;
      int64_t k_end = std::min(k + 64, num_keys);
      for (; k < k_end; ++k) {
        int64_t s = indptr[k], e = indptr[k + 1];
        if (e - s < 2) continue;
        row.assign(static_cast<size_t>(e - s), {});
        for (int64_t p = s; p < e; ++p)
          row[static_cast<size_t>(p - s)] = {indices[p], values[p]};
        std::stable_sort(row.begin(), row.end(),
                         [](auto& a, auto& b) { return a.first < b.first; });
        for (int64_t p = s; p < e; ++p) {
          indices[p] = row[static_cast<size_t>(p - s)].first;
          values[p] = row[static_cast<size_t>(p - s)].second;
        }
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// Dynamic work-queue parallel_for: the TRUE equivalent of the reference's
// ThreadPool / dynamic_parallel_for (src/base/parallel/thread_pool-inl.hpp,
// parallel_lambda.hpp:189-212) — workers pull [lo, hi) chunks off an atomic
// counter, so skewed per-chunk costs balance dynamically, with no GIL
// involved for native callbacks. utils/parallel.py routes here for
// GIL-releasing (numpy/IO) workloads.
typedef void (*cdae_chunk_fn)(int64_t lo, int64_t hi, void* ctx);

void cdae_dynamic_parallel_for(int64_t start, int64_t end, int64_t grain,
                               cdae_chunk_fn fn, void* ctx,
                               int num_threads) {
  if (end <= start) return;
  if (grain < 1) grain = 1;
  int nt = num_threads > 0
               ? num_threads
               : static_cast<int>(std::thread::hardware_concurrency());
  int64_t total = end - start;
  if (nt < 2 || total <= grain) {
    fn(start, end, ctx);
    return;
  }
  std::atomic<int64_t> next(start);
  auto worker = [&] {
    for (;;) {
      int64_t lo = next.fetch_add(grain);
      if (lo >= end) return;
      fn(lo, std::min(lo + grain, end), ctx);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

}  // extern "C"
