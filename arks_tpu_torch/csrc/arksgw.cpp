// Native gateway data-plane hot paths for the PyTorch port (a copy of
// native/arksgw.cpp).
//
// The reference gateway is a compiled Go binary (pkg/gateway/); its two hot
// loops are the per-chunk SSE usage scan in HandleResponseBody
// (handle_response.go:113-182) and the fixed-window rate-limit counters
// (ratelimiter/redis_impl.go:47-168, backed by Redis).  This library is the
// native counterpart for the Python gateway: an in-process counter store
// with wall-clock-window expiry and an incremental SSE scanner that
// tolerates arbitrary chunk fragmentation.  Python binds via ctypes
// (arks_tpu_torch/gateway/native.py, which builds it with g++ at first use
// into build/arks_tpu_torch/); every entry point is C ABI.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>

namespace {

// ---------------------------------------------------------------------------
// Fixed-window counters
// ---------------------------------------------------------------------------

struct Counter {
  long long value;
  double expiry;
};

struct Store {
  std::mutex mu;
  std::unordered_map<std::string, Counter> map;
  size_t gc_at = 65536;  // next size at which to sweep expired entries
};

constexpr size_t kGcThreshold = 65536;

// ---------------------------------------------------------------------------
// SSE usage scanner
// ---------------------------------------------------------------------------

struct Scanner {
  std::string buf;  // unterminated frame tail across feeds
  long long prompt = -1, completion = -1, total = -1;
  bool has_usage = false;
  bool done = false;  // saw the [DONE] sentinel
};

bool parse_ll_after(const std::string& s, const char* key, long long* out) {
  size_t pos = s.find(key);
  if (pos == std::string::npos) return false;
  pos += std::strlen(key);
  while (pos < s.size() &&
         (s[pos] == ' ' || s[pos] == '\t' || s[pos] == ':'))
    pos++;
  if (pos >= s.size() ||
      !(std::isdigit(static_cast<unsigned char>(s[pos])) || s[pos] == '-'))
    return false;
  *out = std::strtoll(s.c_str() + pos, nullptr, 10);
  return true;
}

void handle_frame(Scanner* sc, const std::string& frame) {
  size_t start = 0;
  while (start < frame.size()) {
    size_t end = frame.find('\n', start);
    std::string line = frame.substr(
        start, end == std::string::npos ? std::string::npos : end - start);
    start = end == std::string::npos ? frame.size() : end + 1;
    if (!line.empty() && line.back() == '\r') line.pop_back();
    if (line.rfind("data:", 0) != 0) continue;
    std::string payload = line.substr(5);
    size_t b = payload.find_first_not_of(" \t");
    payload = b == std::string::npos ? "" : payload.substr(b);
    if (payload == "[DONE]") {
      sc->done = true;
      continue;
    }
    // Usage must be a JSON object, not the null most chunks carry.
    size_t up = payload.find("\"usage\"");
    if (up == std::string::npos) continue;
    size_t q = payload.find_first_not_of(" \t:", up + 7);
    if (q == std::string::npos || payload[q] != '{') continue;
    // Bound the scan to the usage object itself (balanced braces) and
    // REPLACE all three fields per frame — later usage frames must fully
    // supersede earlier ones (e.g. per-chunk continuous usage stats), the
    // same whole-dict-replacement semantics as the Python fallback.
    int depth = 0;
    size_t uend = q;
    for (; uend < payload.size(); uend++) {
      if (payload[uend] == '{') depth++;
      else if (payload[uend] == '}' && --depth == 0) { uend++; break; }
    }
    std::string usage = payload.substr(q, uend - q);
    long long p, c, t;
    bool hp = parse_ll_after(usage, "\"prompt_tokens\"", &p);
    bool hc = parse_ll_after(usage, "\"completion_tokens\"", &c);
    bool ht = parse_ll_after(usage, "\"total_tokens\"", &t);
    // Replace all three fields per frame — later usage frames fully
    // supersede earlier ones — but ONLY when the frame carries at least one
    // numeric counter: an empty or non-numeric usage object must not clear
    // previously captured usage (PyUsageScanner applies the same rule).
    if (!(hp || hc || ht)) continue;
    sc->prompt = hp ? p : -1;
    sc->completion = hc ? c : -1;
    sc->total = ht ? t : -1;
    sc->has_usage = true;
  }
}

}  // namespace

extern "C" {

// ---- counters -------------------------------------------------------------

void* arks_store_new() { return new Store(); }

void arks_store_free(void* h) { delete static_cast<Store*>(h); }

long long arks_store_get(void* h, const char* key, double now) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->map.find(key);
  if (it == s->map.end() || it->second.expiry <= now) return 0;
  return it->second.value;
}

long long arks_store_incr(void* h, const char* key, long long amount,
                          double ttl_s, double now) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if (s->map.size() > s->gc_at) {
    // Amortized sweep: if most entries are live (long windows), the next
    // sweep waits for the map to double rather than re-scanning every
    // increment under the mutex.
    for (auto it = s->map.begin(); it != s->map.end();) {
      it = it->second.expiry <= now ? s->map.erase(it) : std::next(it);
    }
    s->gc_at = std::max(kGcThreshold, s->map.size() * 2);
  }
  Counter& c = s->map[key];
  if (c.expiry <= now) {
    c.value = 0;
    c.expiry = now + ttl_s;
  }
  c.value += amount;
  return c.value;
}

long long arks_store_size(void* h) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return static_cast<long long>(s->map.size());
}

// ---- SSE scanner ----------------------------------------------------------

void* arks_sse_new() { return new Scanner(); }

void arks_sse_free(void* h) { delete static_cast<Scanner*>(h); }

void arks_sse_feed(void* h, const char* data, size_t len) {
  Scanner* sc = static_cast<Scanner*>(h);
  sc->buf.append(data, len);
  for (;;) {
    // Frames end at a blank line: "\n\n" or "\r\n\r\n", whichever first.
    size_t a = sc->buf.find("\n\n");
    size_t b = sc->buf.find("\r\n\r\n");
    size_t pos, sep;
    if (a == std::string::npos && b == std::string::npos) break;
    if (b != std::string::npos && (a == std::string::npos || b < a)) {
      pos = b;
      sep = 4;
    } else {
      pos = a;
      sep = 2;
    }
    handle_frame(sc, sc->buf.substr(0, pos));
    sc->buf.erase(0, pos + sep);
  }
}

// Returns 1 when a usage object was seen; fills the three counters
// (absent fields are -1).
int arks_sse_result(void* h, long long* prompt, long long* completion,
                    long long* total) {
  Scanner* sc = static_cast<Scanner*>(h);
  *prompt = sc->prompt;
  *completion = sc->completion;
  *total = sc->total;
  return sc->has_usage ? 1 : 0;
}

int arks_sse_done(void* h) { return static_cast<Scanner*>(h)->done ? 1 : 0; }

}  // extern "C"
