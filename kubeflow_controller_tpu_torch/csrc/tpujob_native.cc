// tpujob_native: C++ runtime core for the reconcile hot path.
//
// The reference's controller machinery is compiled native code (Go:
// client-go's rate-limited workqueue, pkg/controller/controller.go:116, and
// the vendored ControllerExpectations, controller_utils.go:125-287). This is
// the C++ equivalent for the TPU rebuild, exposed through a C ABI consumed
// from Python via ctypes (kubeflow_controller_tpu/native). Semantics match
// controller/workqueue.py and controller/expectations.py exactly — the
// Python implementations remain as the reference/fallback, and the shared
// test suite runs against both.
//
// Build: see csrc/Makefile (g++ -shared -fPIC, C++17, pthreads only).

#include <algorithm>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <queue>
#include <set>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <utility>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

double now_s() {
  return std::chrono::duration<double>(Clock::now().time_since_epoch())
      .count();
}

// Capped exponential backoff with deterministic jitter — bit-identical to
// controller/workqueue.py::backoff_delay (IEEE doubles, same operation
// order; parity pinned by tests/test_native.py). The jitter scales the
// capped delay into [0.75, 1.0) via an FNV-1a hash of "<key>|<failures>",
// desynchronizing keys that started failing together without RNG state.
constexpr int kBackoffMaxExp = 32;

double BackoffDelay(double base_delay, double max_delay, const char* key,
                    int failures) {
  int exp = failures < kBackoffMaxExp ? failures : kBackoffMaxExp;
  double raw = base_delay * std::pow(2.0, exp);
  if (raw > max_delay) raw = max_delay;
  std::string s = std::string(key) + "|" + std::to_string(failures);
  uint32_t h = 2166136261u;
  for (unsigned char c : s) {
    h = (h ^ c) * 16777619u;
  }
  double frac = h / 4294967296.0;
  return raw * (0.75 + 0.25 * frac);
}

struct DelayedItem {
  double due;
  uint64_t seq;
  std::string key;
  bool operator>(const DelayedItem& o) const {
    return due != o.due ? due > o.due : seq > o.seq;
  }
};

class WorkQueue {
 public:
  WorkQueue(double base_delay, double max_delay)
      : base_delay_(base_delay), max_delay_(max_delay) {}

  void Add(const std::string& key) {
    std::lock_guard<std::mutex> g(mu_);
    AddLocked(key);
  }

  void AddAfter(const std::string& key, double delay) {
    if (delay <= 0) {
      Add(key);
      return;
    }
    std::lock_guard<std::mutex> g(mu_);
    if (shutdown_) return;
    double due = now_s() + delay;
    if (queued_.count(key)) {
      auto it = delayed_due_.find(key);
      // Already ready in the FIFO: fires sooner than any delay.
      if (it == delayed_due_.end()) return;
      // Parked with an earlier-or-equal deadline already.
      if (due >= it->second) return;
      // Parked with a LATER deadline: keep the earliest one (client-go
      // delaying-queue semantics). The old heap entry goes stale and is
      // skipped when it surfaces in PromoteDueLocked.
    } else {
      queued_.insert(key);
    }
    delayed_due_[key] = due;
    delayed_.push(DelayedItem{due, seq_++, key});
    cv_.notify_one();
  }

  void AddRateLimited(const std::string& key) {
    double delay;
    {
      std::lock_guard<std::mutex> g(mu_);
      int failures = failures_[key]++;
      delay = BackoffDelay(base_delay_, max_delay_, key.c_str(), failures);
    }
    AddAfter(key, delay);
  }

  void Forget(const std::string& key) {
    std::lock_guard<std::mutex> g(mu_);
    failures_.erase(key);
  }

  int NumRequeues(const std::string& key) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = failures_.find(key);
    return it == failures_.end() ? 0 : it->second;
  }

  // Returns true and fills out; false on shutdown or timeout.
  bool Get(double timeout, std::string* out) {
    std::unique_lock<std::mutex> lk(mu_);
    const bool has_deadline = timeout >= 0;
    const double deadline = now_s() + (has_deadline ? timeout : 0);
    while (true) {
      double next_due = PromoteDueLocked();
      if (!fifo_.empty()) {
        *out = fifo_.front();
        fifo_.pop_front();
        queued_.erase(*out);
        processing_.insert(*out);
        return true;
      }
      if (shutdown_) return false;
      double wait = next_due;  // <0 == no delayed items
      if (has_deadline) {
        double remain = deadline - now_s();
        if (remain <= 0) return false;
        wait = wait < 0 ? remain : std::min(wait, remain);
      }
      if (wait < 0) {
        cv_.wait(lk);
      } else {
        cv_.wait_for(lk, std::chrono::duration<double>(wait));
      }
    }
  }

  void Done(const std::string& key) {
    std::lock_guard<std::mutex> g(mu_);
    processing_.erase(key);
    if (redo_.erase(key)) {
      queued_.insert(key);
      fifo_.push_back(key);
      cv_.notify_one();
    }
  }

  void Shutdown() {
    std::lock_guard<std::mutex> g(mu_);
    shutdown_ = true;
    cv_.notify_all();
  }

  int Len() {
    std::lock_guard<std::mutex> g(mu_);
    // delayed_due_ counts real parked items; delayed_ may hold stale
    // superseded entries.
    return static_cast<int>(fifo_.size() + delayed_due_.size());
  }

  bool EmptyAndIdle() {
    std::lock_guard<std::mutex> g(mu_);
    return fifo_.empty() && delayed_due_.empty() && processing_.empty() &&
           redo_.empty();
  }

 private:
  bool InFifoLocked(const std::string& key) const {
    for (const auto& k : fifo_) {
      if (k == key) return true;
    }
    return false;
  }

  void AddLocked(const std::string& key) {
    if (shutdown_) return;
    if (processing_.count(key)) {
      redo_.insert(key);
      return;
    }
    if (queued_.count(key)) {
      // Parked in the delayed heap (AddAfter): an immediate add BEATS the
      // pending delay — k8s workqueue semantics. Without this, a key
      // parked for a long TTL/backoff swallows event-driven re-enqueues
      // until the delay fires.
      if (!InFifoLocked(key)) {
        // The parked heap entry goes stale (due-map cleared) and is
        // skipped when it surfaces.
        delayed_due_.erase(key);
        fifo_.push_back(key);
        cv_.notify_one();
      }
      return;
    }
    queued_.insert(key);
    fifo_.push_back(key);
    cv_.notify_one();
  }

  // Moves due delayed items to the FIFO. Returns seconds until the next
  // delayed item, or -1 if none.
  double PromoteDueLocked() {
    double now = now_s();
    while (!delayed_.empty()) {
      const DelayedItem& top = delayed_.top();
      auto it = delayed_due_.find(top.key);
      if (it == delayed_due_.end() || it->second != top.due) {
        // Stale: superseded by a shorter deadline or an immediate Add.
        delayed_.pop();
        continue;
      }
      if (top.due > now) break;
      std::string key = top.key;
      delayed_.pop();
      delayed_due_.erase(key);
      if (queued_.count(key)) {  // not cancelled
        if (processing_.count(key)) {
          redo_.insert(key);
          queued_.erase(key);
        } else if (!InFifoLocked(key)) {
          // (an immediate Add may have promoted it already)
          fifo_.push_back(key);
        }
      }
    }
    return delayed_.empty() ? -1.0 : delayed_.top().due - now;
  }

  const double base_delay_;
  const double max_delay_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<std::string> fifo_;
  std::unordered_set<std::string> queued_;
  std::unordered_set<std::string> processing_;
  std::unordered_set<std::string> redo_;
  std::priority_queue<DelayedItem, std::vector<DelayedItem>,
                      std::greater<DelayedItem>>
      delayed_;
  // key -> authoritative due time; heap entries that disagree are stale.
  std::unordered_map<std::string, double> delayed_due_;
  uint64_t seq_ = 0;
  std::unordered_map<std::string, int> failures_;
  bool shutdown_ = false;
};

// -- expectations ------------------------------------------------------------

class Expectations {
 public:
  explicit Expectations(double ttl) : ttl_(ttl) {}

  bool Satisfied(const std::string& key) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = store_.find(key);
    if (it == store_.end()) return true;
    const Rec& r = it->second;
    return (r.adds <= 0 && r.dels <= 0) || (now_s() - r.ts > ttl_);
  }

  void ExpectCreations(const std::string& key, int n) {
    std::lock_guard<std::mutex> g(mu_);
    store_[key] = Rec{n, 0, now_s()};
  }

  void ExpectDeletions(const std::string& key, int n) {
    std::lock_guard<std::mutex> g(mu_);
    store_[key] = Rec{0, n, now_s()};
  }

  void CreationObserved(const std::string& key) { Lower(key, 1, 0); }
  void DeletionObserved(const std::string& key) { Lower(key, 0, 1); }

  void DeleteExpectations(const std::string& key) {
    std::lock_guard<std::mutex> g(mu_);
    store_.erase(key);
  }

  // Returns 1 and fills adds/dels if present, else 0.
  int Pending(const std::string& key, int* adds, int* dels) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = store_.find(key);
    if (it == store_.end()) return 0;
    *adds = it->second.adds;
    *dels = it->second.dels;
    return 1;
  }

 private:
  struct Rec {
    int adds = 0;
    int dels = 0;
    double ts = 0;
  };

  void Lower(const std::string& key, int adds, int dels) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = store_.find(key);
    if (it == store_.end()) return;
    it->second.adds -= adds;
    it->second.dels -= dels;
  }

  const double ttl_;
  std::mutex mu_;
  std::unordered_map<std::string, Rec> store_;
};

// -- object index ------------------------------------------------------------
//
// Write-through mirror of the Python ObjectStore's sync-relevant state:
// per-kind key -> (uid, resourceVersion, generation, labels-of-interest)
// records, the label index (store.py::_index_add/_index_remove), and the
// controller's no-op-sync fingerprint (Controller._sync_fingerprint) held as
// a canonical string per job key. Python keeps authoritative storage and the
// deterministic flush() contract; this index exists so a steady resync probe
// touches zero Python object traversals.
//
// Fingerprint protocol is two-phase to stay correct under threaded workers:
// FpProbe computes the canonical fingerprint from current index state and
// compares it with the last committed one. On a hit nothing changes; on a
// miss the candidate parks in a pending slot keyed by job key. FpCommit
// promotes pending -> committed verbatim — it never recomputes, so a write
// racing between probe and commit cannot smuggle an unobserved state into
// the committed fingerprint (the workqueue guarantees one worker per key, so
// the pending slot has a single writer).

class ObjectIndex {
 public:
  void Upsert(const std::string& kind, const std::string& key,
              const std::string& uid, long long rv, long long gen,
              const std::vector<std::pair<std::string, std::string>>& labels) {
    Kind& k = KindFor(kind);
    std::lock_guard<std::mutex> g(k.mu);
    auto it = k.objs.find(key);
    if (it != k.objs.end()) {
      for (const auto& lv : it->second.labels) {
        IndexRemoveLocked(k, lv.first, lv.second, key);
      }
      it->second.uid = uid;
      it->second.rv = rv;
      it->second.gen = gen;
      it->second.labels = labels;
    } else {
      k.objs.emplace(key, Rec{uid, rv, gen, labels});
    }
    for (const auto& lv : labels) {
      k.index[lv.first][lv.second].insert(key);
    }
  }

  void Remove(const std::string& kind, const std::string& key) {
    Kind& k = KindFor(kind);
    std::lock_guard<std::mutex> g(k.mu);
    auto it = k.objs.find(key);
    if (it == k.objs.end()) return;
    for (const auto& lv : it->second.labels) {
      IndexRemoveLocked(k, lv.first, lv.second, key);
    }
    k.objs.erase(it);
  }

  int Count(const std::string& kind) {
    Kind& k = KindFor(kind);
    std::lock_guard<std::mutex> g(k.mu);
    return static_cast<int>(k.objs.size());
  }

  int BucketCount(const std::string& kind, const std::string& label_key) {
    Kind& k = KindFor(kind);
    std::lock_guard<std::mutex> g(k.mu);
    auto it = k.index.find(label_key);
    return it == k.index.end() ? 0 : static_cast<int>(it->second.size());
  }

  // Newline-joined sorted member keys of one label bucket (parity tests).
  std::string BucketKeys(const std::string& kind, const std::string& label_key,
                         const std::string& value) {
    Kind& k = KindFor(kind);
    std::lock_guard<std::mutex> g(k.mu);
    std::string out;
    auto it = k.index.find(label_key);
    if (it == k.index.end()) return out;
    auto vit = it->second.find(value);
    if (vit == it->second.end()) return out;
    for (const auto& key : vit->second) {
      if (!out.empty()) out += '\n';
      out += key;
    }
    return out;
  }

  // Canonical fingerprint: job identity + the (uid, rv) pairs of every
  // bucket member in `namespace`, sorted by uid — string-equal iff the
  // Python tuple fingerprint is tuple-equal (uids are unique; both sides
  // sort the same ASCII uids). kind_b may be empty (no second bucket, e.g.
  // LMService has no owned Services in its fingerprint).
  int FpProbe(const std::string& job_key, const std::string& ident,
              const std::string& ns, const std::string& kind_a,
              const std::string& lk_a, const std::string& lv_a,
              const std::string& kind_b, const std::string& lk_b,
              const std::string& lv_b, const std::string& health) {
    std::string fp = ident;
    fp += '\x01';
    fp += BucketFp(kind_a, lk_a, lv_a, ns);
    fp += '\x01';
    if (!kind_b.empty()) fp += BucketFp(kind_b, lk_b, lv_b, ns);
    fp += '\x01';
    fp += health;
    std::lock_guard<std::mutex> g(fp_mu_);
    auto it = fp_.find(job_key);
    if (it != fp_.end() && it->second == fp) {
      ++fp_hits_;
      fp_pending_.erase(job_key);
      return 1;
    }
    ++fp_misses_;
    fp_pending_[job_key] = std::move(fp);
    return 0;
  }

  void FpCommit(const std::string& job_key) {
    std::lock_guard<std::mutex> g(fp_mu_);
    auto it = fp_pending_.find(job_key);
    if (it == fp_pending_.end()) return;
    fp_[job_key] = std::move(it->second);
    fp_pending_.erase(it);
  }

  void FpForget(const std::string& job_key) {
    std::lock_guard<std::mutex> g(fp_mu_);
    fp_.erase(job_key);
    fp_pending_.erase(job_key);
  }

  void FpCounts(long long* hits, long long* misses) {
    std::lock_guard<std::mutex> g(fp_mu_);
    *hits = fp_hits_;
    *misses = fp_misses_;
  }

  // -- slice-health mirror ---------------------------------------------------
  // Write-through mirror of the slice pool's holdings, keyed by holder (job
  // uid): holder -> {slice name -> healthy}. cluster/slices.py writes through
  // on every holder/health mutation under the pool lock, so FpProbeMirrored
  // can compose the slice-health fingerprint term natively — the steady
  // probe touches zero Python slice traversals.

  void SliceSet(const std::string& holder, const std::string& name,
                bool healthy) {
    std::lock_guard<std::mutex> g(slice_mu_);
    slices_[holder][name] = healthy;
  }

  void SliceClear(const std::string& holder, const std::string& name) {
    std::lock_guard<std::mutex> g(slice_mu_);
    auto it = slices_.find(holder);
    if (it == slices_.end()) return;
    it->second.erase(name);
    if (it->second.empty()) slices_.erase(it);
  }

  // FpProbe with the health term composed from the mirror. want_health == 0
  // encodes "planner will not read health" as "-" (the Python path's
  // health_key=None); want_health != 0 with no held slices encodes as the
  // empty string — distinct from "-", mirroring None vs empty tuple.
  // Entries are name-sorted (std::map iteration; names are unique per
  // holder, so this matches Python's sorted((name, healthy)) order).
  int FpProbeMirrored(const std::string& job_key, const std::string& ident,
                      const std::string& ns, const std::string& kind_a,
                      const std::string& lk_a, const std::string& lv_a,
                      const std::string& kind_b, const std::string& lk_b,
                      const std::string& lv_b, const std::string& health_uid,
                      int want_health) {
    std::string health = "-";
    if (want_health) {
      health.clear();
      std::lock_guard<std::mutex> g(slice_mu_);
      auto it = slices_.find(health_uid);
      if (it != slices_.end()) {
        for (const auto& nv : it->second) {
          health += nv.first;
          health += '\x04';
          health += nv.second ? '1' : '0';
          health += '\x05';
        }
      }
    }
    return FpProbe(job_key, ident, ns, kind_a, lk_a, lv_a, kind_b, lk_b,
                   lv_b, health);
  }

 private:
  struct Rec {
    std::string uid;
    long long rv = 0;
    long long gen = 0;
    std::vector<std::pair<std::string, std::string>> labels;
  };
  struct Kind {
    std::mutex mu;
    std::unordered_map<std::string, Rec> objs;
    std::unordered_map<
        std::string, std::unordered_map<std::string, std::set<std::string>>>
        index;
  };

  Kind& KindFor(const std::string& kind) {
    std::lock_guard<std::mutex> g(kinds_mu_);
    auto it = kinds_.find(kind);
    if (it == kinds_.end()) {
      it = kinds_.emplace(kind, std::unique_ptr<Kind>(new Kind)).first;
    }
    return *it->second;
  }

  static void IndexRemoveLocked(Kind& k, const std::string& lk,
                                const std::string& lv,
                                const std::string& key) {
    auto it = k.index.find(lk);
    if (it == k.index.end()) return;
    auto vit = it->second.find(lv);
    if (vit == it->second.end()) return;
    vit->second.erase(key);
    if (vit->second.empty()) it->second.erase(vit);
  }

  std::string BucketFp(const std::string& kind, const std::string& lk,
                       const std::string& lv, const std::string& ns) {
    Kind& k = KindFor(kind);
    std::string prefix = ns + "/";
    std::vector<std::pair<std::string, long long>> members;
    {
      std::lock_guard<std::mutex> g(k.mu);
      auto it = k.index.find(lk);
      if (it != k.index.end()) {
        auto vit = it->second.find(lv);
        if (vit != it->second.end()) {
          for (const auto& key : vit->second) {
            if (key.compare(0, prefix.size(), prefix) != 0) continue;
            auto oit = k.objs.find(key);
            if (oit != k.objs.end()) {
              members.emplace_back(oit->second.uid, oit->second.rv);
            }
          }
        }
      }
    }
    std::sort(members.begin(), members.end());
    std::string out;
    for (const auto& m : members) {
      out += m.first;
      out += '\x02';
      out += std::to_string(m.second);
      out += '\x03';
    }
    return out;
  }

  std::mutex kinds_mu_;
  std::unordered_map<std::string, std::unique_ptr<Kind>> kinds_;
  std::mutex fp_mu_;
  std::unordered_map<std::string, std::string> fp_;
  std::unordered_map<std::string, std::string> fp_pending_;
  long long fp_hits_ = 0;
  long long fp_misses_ = 0;
  std::mutex slice_mu_;
  std::map<std::string, std::map<std::string, bool>> slices_;
};

}  // namespace

// -- C ABI -------------------------------------------------------------------

extern "C" {

void* wq_new(double base_delay, double max_delay) {
  return new WorkQueue(base_delay, max_delay);
}
// Pure backoff computation, exposed so the Python<->C++ parity contract is
// testable directly (tests/test_native.py) without timing a live queue.
double wq_backoff_delay(double base_delay, double max_delay, const char* key,
                        int failures) {
  return BackoffDelay(base_delay, max_delay, key, failures);
}
void wq_free(void* h) { delete static_cast<WorkQueue*>(h); }
void wq_add(void* h, const char* key) {
  static_cast<WorkQueue*>(h)->Add(key);
}
void wq_add_after(void* h, const char* key, double delay) {
  static_cast<WorkQueue*>(h)->AddAfter(key, delay);
}
void wq_add_rate_limited(void* h, const char* key) {
  static_cast<WorkQueue*>(h)->AddRateLimited(key);
}
void wq_forget(void* h, const char* key) {
  static_cast<WorkQueue*>(h)->Forget(key);
}
int wq_num_requeues(void* h, const char* key) {
  return static_cast<WorkQueue*>(h)->NumRequeues(key);
}
// timeout < 0 means block until item or shutdown. Returns length written
// (excluding NUL), -1 when no item (shutdown/timeout), -2 if buf too small.
int wq_get(void* h, double timeout, char* buf, int buflen) {
  std::string out;
  WorkQueue* q = static_cast<WorkQueue*>(h);
  if (!q->Get(timeout, &out)) return -1;
  if (static_cast<int>(out.size()) + 1 > buflen) {
    // The key cannot be returned, so retire it from the processing set —
    // otherwise it stays in-flight forever and empty_and_idle() wedges for
    // every consumer. The caller still sees -2 and reports the loss.
    q->Done(out);
    return -2;
  }
  std::memcpy(buf, out.data(), out.size());
  buf[out.size()] = '\0';
  return static_cast<int>(out.size());
}
void wq_done(void* h, const char* key) {
  static_cast<WorkQueue*>(h)->Done(key);
}
void wq_shutdown(void* h) { static_cast<WorkQueue*>(h)->Shutdown(); }
int wq_len(void* h) { return static_cast<WorkQueue*>(h)->Len(); }
int wq_empty_and_idle(void* h) {
  return static_cast<WorkQueue*>(h)->EmptyAndIdle() ? 1 : 0;
}

void* exp_new(double ttl) { return new Expectations(ttl); }
void exp_free(void* h) { delete static_cast<Expectations*>(h); }
int exp_satisfied(void* h, const char* key) {
  return static_cast<Expectations*>(h)->Satisfied(key) ? 1 : 0;
}
void exp_expect_creations(void* h, const char* key, int n) {
  static_cast<Expectations*>(h)->ExpectCreations(key, n);
}
void exp_expect_deletions(void* h, const char* key, int n) {
  static_cast<Expectations*>(h)->ExpectDeletions(key, n);
}
void exp_creation_observed(void* h, const char* key) {
  static_cast<Expectations*>(h)->CreationObserved(key);
}
void exp_deletion_observed(void* h, const char* key) {
  static_cast<Expectations*>(h)->DeletionObserved(key);
}
void exp_delete(void* h, const char* key) {
  static_cast<Expectations*>(h)->DeleteExpectations(key);
}
int exp_pending(void* h, const char* key, int* adds, int* dels) {
  return static_cast<Expectations*>(h)->Pending(key, adds, dels);
}

void* oix_new() { return new ObjectIndex(); }
void oix_free(void* h) { delete static_cast<ObjectIndex*>(h); }
// labels: "k\x1fv" pairs joined by "\x1e"; empty string == no labels.
void oix_upsert(void* h, const char* kind, const char* key, const char* uid,
                long long rv, long long gen, const char* labels) {
  std::vector<std::pair<std::string, std::string>> lv;
  const char* p = labels;
  while (p && *p) {
    const char* end = std::strchr(p, '\x1e');
    size_t n = end ? static_cast<size_t>(end - p) : std::strlen(p);
    const char* sep =
        static_cast<const char*>(std::memchr(p, '\x1f', n));
    if (sep) {
      lv.emplace_back(std::string(p, sep),
                      std::string(sep + 1, p + n - (sep + 1)));
    }
    p = end ? end + 1 : nullptr;
  }
  static_cast<ObjectIndex*>(h)->Upsert(kind, key, uid, rv, gen, lv);
}
void oix_remove(void* h, const char* kind, const char* key) {
  static_cast<ObjectIndex*>(h)->Remove(kind, key);
}
int oix_count(void* h, const char* kind) {
  return static_cast<ObjectIndex*>(h)->Count(kind);
}
int oix_bucket_count(void* h, const char* kind, const char* label_key) {
  return static_cast<ObjectIndex*>(h)->BucketCount(kind, label_key);
}
// Returns length written (excluding NUL); -2 if buf too small (nothing
// written). Keys come back newline-joined, sorted.
int oix_bucket_keys(void* h, const char* kind, const char* label_key,
                    const char* value, char* buf, int buflen) {
  std::string out =
      static_cast<ObjectIndex*>(h)->BucketKeys(kind, label_key, value);
  if (static_cast<int>(out.size()) + 1 > buflen) return -2;
  std::memcpy(buf, out.data(), out.size());
  buf[out.size()] = '\0';
  return static_cast<int>(out.size());
}
// 1 == fingerprint hit (steady, skip the sync); 0 == miss (candidate parked
// for oix_fp_commit). kind_b may be "" to fingerprint a single bucket.
int oix_fp_probe(void* h, const char* job_key, const char* ident,
                 const char* ns, const char* kind_a, const char* lk_a,
                 const char* lv_a, const char* kind_b, const char* lk_b,
                 const char* lv_b, const char* health) {
  return static_cast<ObjectIndex*>(h)->FpProbe(job_key, ident, ns, kind_a,
                                               lk_a, lv_a, kind_b, lk_b,
                                               lv_b, health);
}
void oix_fp_commit(void* h, const char* job_key) {
  static_cast<ObjectIndex*>(h)->FpCommit(job_key);
}
void oix_fp_forget(void* h, const char* job_key) {
  static_cast<ObjectIndex*>(h)->FpForget(job_key);
}
void oix_fp_counts(void* h, long long* hits, long long* misses) {
  static_cast<ObjectIndex*>(h)->FpCounts(hits, misses);
}
// Slice-health mirror: write-through from the slice pool so oix_fp_probe2
// composes the health term natively (no Python traversal per probe).
void oix_slice_set(void* h, const char* holder, const char* name,
                   int healthy) {
  static_cast<ObjectIndex*>(h)->SliceSet(holder, name, healthy != 0);
}
void oix_slice_clear(void* h, const char* holder, const char* name) {
  static_cast<ObjectIndex*>(h)->SliceClear(holder, name);
}
// oix_fp_probe with the health term read from the mirror keyed by
// health_uid; want_health == 0 means the planner ignores health for this
// job ("-" sentinel, matching the Python health_key=None case).
int oix_fp_probe2(void* h, const char* job_key, const char* ident,
                  const char* ns, const char* kind_a, const char* lk_a,
                  const char* lv_a, const char* kind_b, const char* lk_b,
                  const char* lv_b, const char* health_uid,
                  int want_health) {
  return static_cast<ObjectIndex*>(h)->FpProbeMirrored(
      job_key, ident, ns, kind_a, lk_a, lv_a, kind_b, lk_b, lv_b,
      health_uid, want_health);
}

}  // extern "C"
